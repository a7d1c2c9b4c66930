"""Parallelism over `torch.distributed`: the data axis (`parallel/mesh.py`)
and the spatial H-sharding (`parallel/spatial.py`)."""
