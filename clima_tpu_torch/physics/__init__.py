from . import eqns, water, saturation  # noqa: F401
