"""Model parallelism of the port: the TCN's hidden width
(``tensor_parallel.py``) or the dual-path separator's heads and FFN width
(``dpt_tp.py``) split over shard devices, placed by ``mesh.py``."""
