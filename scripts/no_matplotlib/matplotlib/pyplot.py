"""pyplot of the stand-in: any attribute is a call that does nothing and
returns an object of the same kind; `savefig` records its path."""

import atexit
import sys

LEFT_OUT = []


class _Nothing:
    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return self


def savefig(path, *args, **kwargs):
    LEFT_OUT.append(str(path))


def __getattr__(name):
    return _Nothing()


@atexit.register
def _report():
    if LEFT_OUT:
        print(f"no matplotlib: {len(LEFT_OUT)} plot(s) left out: "
              + ", ".join(LEFT_OUT), file=sys.stderr, flush=True)
