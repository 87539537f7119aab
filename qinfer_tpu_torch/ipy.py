"""Notebook progress bar. Counterpart of ``qinfer_tpu/ipy.py``: an
ipywidgets ``FloatProgress`` when ipywidgets is installed, a bar that only
counts otherwise."""

from __future__ import annotations

__all__ = ["IPythonProgressBar"]


class IPythonProgressBar:
    """``start(max)``, ``update(n)``, ``finished()`` and ``description``,
    on an ipywidgets bar when one can be made."""

    def __init__(self):
        try:
            import ipywidgets

            self.widget = ipywidgets.FloatProgress(
                value=0.0, min=0.0, max=100.0, description="Progress:")
        except ImportError:
            self.widget = None
        self._max = 100.0
        self._value = 0.0

    @property
    def description(self):
        if self.widget is not None:
            return self.widget.description
        return "Progress:"

    @description.setter
    def description(self, value):
        if self.widget is not None:
            self.widget.description = value

    def start(self, max_value):
        self._max = float(max_value)
        self._value = 0.0
        if self.widget is not None:
            self.widget.max = float(max_value)
            try:
                from IPython.display import display
            except ImportError:
                return
            display(self.widget)

    def update(self, n):
        self._value = float(n)
        if self.widget is not None:
            self.widget.value = float(n)

    def finished(self):
        self.update(self._max)
