"""Tools of the port, each run as ``python -m clima_tpu_torch.tools.<name>``:
measurements on a CUDA card (``roofline``: every kernel against its bound,
whose byte and operation counts ``chip_smoke.py`` also uses; ``validation``:
the card against the CPU; ``rce_bench``: ``batched_rce`` over column
ensembles; ``scaling``: columns/s against ranks; ``profile_stages``: the
radtran chain by stage; ``opacity_substages``: ``compute_opacity`` by stage;
``rorr_crossover``: the RORR kernel against the sort path across nbin;
``compare_twostream_builds``)
and the ranks of a multi-process run (``distributed_worker``, spawned with
``torch.multiprocessing``)."""
