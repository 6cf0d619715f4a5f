from . import eqns, water  # noqa: F401
