"""Warning and exception types. Counterpart of
``qinfer_tpu/_exceptions.py``."""


class ApproximationWarning(Warning):
    """Flags degraded approximation quality (e.g. total weight collapse).

    Counterpart of ``qinfer_tpu._exceptions.ApproximationWarning``.
    """


class ResamplerWarning(Warning):
    """Flags resampler irregularities (e.g. postselection exhaustion)."""


class ResamplerError(RuntimeError):
    """Raised when resampling cannot produce valid particles."""
