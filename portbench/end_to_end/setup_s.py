"""setup_s: seconds from the process's start to the first timed request:
imports, data, the base's load (the HNSW bulk build), the service and
server, the client process and the warm-up."""


def read(run):
    return run.setup["setup_s"]
