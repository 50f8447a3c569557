"""The plain reference: exact search and stored rows in plain PyTorch, in
float32 with TF32 off, worked in blocks. It imports neither JAX nor the
JAX package nor anything of `scintirete_tpu_torch`, and takes nothing the
program made: it works from the inputs the benchmark generated, and reads
the program's answers only to judge them."""
