"""Tools of the port, each run as ``python -m clima_tpu_torch.tools.<name>``:
measurements on a CUDA card (``roofline``: every kernel against its bound,
whose byte and operation counts ``chip_smoke.py`` also uses; ``validation``:
the card against the CPU; ``rce_bench``: ``batched_rce`` over column
ensembles; ``scaling``: columns/s against ranks; ``compare_twostream_builds``)
and the ranks of a multi-process run (``distributed_worker``, spawned with
``torch.multiprocessing``)."""
