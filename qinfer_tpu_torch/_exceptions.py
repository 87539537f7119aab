"""Warning types. Counterpart of ``qinfer_tpu/_exceptions.py``."""


class ApproximationWarning(Warning):
    """Flags degraded approximation quality (e.g. total weight collapse).

    Counterpart of ``qinfer_tpu._exceptions.ApproximationWarning``.
    """
