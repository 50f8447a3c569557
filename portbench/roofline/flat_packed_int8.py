"""`lane_topk_scan_packed_int8` (`csrc/flat_scan.cu`, C entry
`scnt_flat_packed_int8`: the query and column preparation, the s8 `wgmma`
scan and, where the walk is split, the merge of its slices). Work of one
call, from its shapes: 2 B N D operations (int8); bytes: the queries
[B, D] f32, the int8 rows [N, D], their scales, norms and masks [N] f32,
read once, and the [B, 2048] keys (f32) and rows (i32) written once."""

WRAP = ("scintirete_tpu_torch.ops.packed_scan", "lane_topk_scan_packed_int8")
KERNELS = ("flat_scan_kernel", "prep_queries_int8", "prep_columns_int8",
           "merge_slices")
OUT_COLUMNS = 2048


def shape_of(queries, base8, *args, **kwargs) -> dict:
    return {"B": int(queries.shape[0]), "N": int(base8.shape[0]),
            "D": int(base8.shape[1])}


def work(s: dict) -> tuple[float, float, str]:
    B, N, D = s["B"], s["N"], s["D"]
    nbytes = 4 * B * D + N * D + 12 * N + 8 * B * OUT_COLUMNS
    return 2.0 * B * N * D, float(nbytes), "int8"
