"""Model parallelism of the port: the TCN's hidden width split over shard
devices (``tensor_parallel.py``), placed by ``mesh.py``."""
