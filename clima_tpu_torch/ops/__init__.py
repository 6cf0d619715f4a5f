from . import rebin, interp, tridiag, twostream, rorr, twostream_cuda, rorr_cuda  # noqa: F401
