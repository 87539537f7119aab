"""duecredit stub, a no-op so that the package works without the optional
duecredit dependency. Counterpart of ``qinfer_tpu/_due.py``."""


class _InactiveDueCreditCollector:
    def _donothing(self, *args, **kwargs):
        pass

    def dcite(self, *args, **kwargs):
        def decorator(func):
            return func

        return decorator

    cite = load = add = _donothing

    def __repr__(self):
        return f"{self.__class__.__name__}()"


due = _InactiveDueCreditCollector()


def BibTeX(*args, **kwargs):
    pass


def Doi(*args, **kwargs):
    pass
