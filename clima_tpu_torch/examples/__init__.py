"""The JAX package's four examples on the port, each runnable as ``python -m
clima_tpu_torch.examples.<name>`` (on the card; ``main(device="cpu")`` runs
it on the CPU): ``modern_earth_radtran``, ``tutorial_adiabat_climate``,
``early_mars`` and ``climate_evolve``. Each builds the synthetic template in
memory (``data.make_template``), writes its files to ``root`` (a new
temporary directory by default) and returns the numbers it prints."""
