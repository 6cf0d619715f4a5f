"""Tools of the port: measurements on a CUDA card (``python -m
compare_twostream_builds``) and the ranks of a multi-process run
(``distributed_worker``, spawned with ``torch.multiprocessing``)."""
