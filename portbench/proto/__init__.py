"""A frozen copy of the port's `scintirete.proto` and its generated
`scintirete_pb2.py`, for the benchmark's client processes, which import
nothing of the program. The copy is the wire contract the benchmark holds
the server to; a later change to the program's proto does not change it."""
