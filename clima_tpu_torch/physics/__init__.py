from . import eqns  # noqa: F401
