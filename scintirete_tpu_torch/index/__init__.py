"""HNSW index: host graph store, device mirror and pivot search, bulk build."""
