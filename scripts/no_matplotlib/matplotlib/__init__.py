"""A stand-in for matplotlib on a machine that has none: every plotting
call does nothing and `pyplot.savefig` writes no file.  Put its parent
directory first on PYTHONPATH only where `importlib.util.find_spec
("matplotlib")` finds nothing (scripts/torch_s2d64_card.sh does); at exit
the process prints one line naming every plot it left out."""


def use(*args, **kwargs):
    pass
