"""Version metadata. Counterpart of ``qinfer_tpu/version.py``."""

__version__ = "0.3.0"
version = __version__
