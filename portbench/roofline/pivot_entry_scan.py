"""`pivot_entry_scan` (`csrc/pivot_scan.cu`, C entry
`scnt_pivot_entry_scan`): each query's nearest row of the pivot table,
f32 FMA on the CUDA cores. Work of one call, from its shapes:
2 B R D operations (f32); bytes: the queries [B, D] f32, the pivot rows
[R, D] f32, their norms and deletion flags [R] f32, read once, and the
best distance and row [B] (f32, i32) written once."""

WRAP = ("scintirete_tpu_torch.index.device", "pivot_entry_scan")
KERNELS = ("pivot_scan_kernel", "finish_keys")


def shape_of(queries, pivot_vecs, *args, **kwargs) -> dict:
    return {"B": int(queries.shape[0]), "R": int(pivot_vecs.shape[0]),
            "D": int(queries.shape[1])}


def work(s: dict) -> tuple[float, float, str]:
    B, R, D = s["B"], s["R"], s["D"]
    return 2.0 * B * R * D, 4.0 * (B * D + R * D + 2 * R + 2 * B), "f32"
