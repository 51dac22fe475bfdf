"""Dataset dispatch (own copy of `anoddpm_tpu/data/datasets.py:
dataset_from_args` and `anomalous_dataset_from_args`, synthetic family
only).  Training samples are {"image": (H, W, C), "filenames"}; anomalous
samples are {"image": (S, H, W, C), "mask": (S, H, W, C), "filenames",
"slices"}; float32 numpy arrays in [-1, 1]."""

from __future__ import annotations

from .synthetic import SyntheticAnomalyDataset, SyntheticMRIDataset


def _family(args) -> str:
    name = str(args.get("dataset", "") or "synthetic").lower()
    if name != "synthetic":
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md, Queue 1: "
            "detection sweeps and the real-data families)")
    return name


def dataset_from_args(root_dir: str, args, train: bool = True):
    """The healthy training (seed 0) or test (seed 1) set named by
    args["dataset"]; the port has the synthetic family so far."""
    del root_dir  # the synthetic family is generated, not read
    _family(args)
    return SyntheticMRIDataset(img_size=args["img_size"],
                               seed=0 if train else 1)


def anomalous_dataset_from_args(root_dir: str, args):
    """The anomalous set named by args["dataset"]; the port has the
    synthetic family so far."""
    del root_dir
    _family(args)
    kind = str(args.get("lesion_kind") or "bump")
    severity = float(args.get("lesion_severity") or 1.0)
    vols = args.get("anomalous_volumes")
    length = 22 if vols is None or vols == "" else int(vols)
    if length <= 0:
        raise ValueError(f"anomalous_volumes must be > 0, got {vols!r}")
    return SyntheticAnomalyDataset(img_size=args["img_size"], length=length,
                                   lesion_kind=kind, lesion_severity=severity)
