"""The port's config loader warns on unknown keys, as the JAX package's
does: a misspelled key would otherwise resolve to "" without a sign."""
import glob
import json
import pathlib
import warnings

import pytest

from anoddpm_tpu.config import KNOWN_KEYS as JAX_KNOWN_KEYS
from anoddpm_torch.config import KNOWN_KEYS, load_args, validate_args

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_typo_key_warns_and_passes_through(tmp_path):
    cfg = {"img_size": [64, 64], "Batch_Size": 1, "samle_distance": 100}
    (tmp_path / "args9.json").write_text(json.dumps(cfg))
    with pytest.warns(UserWarning, match="samle_distance"):
        args = load_args("9", config_dir=str(tmp_path))
    assert args["samle_distance"] == 100 and args["sample_distance"] == ""
    assert validate_args({"T": 1, "zz": 0, "aa": 1}) == ["aa", "zz"]


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs" / "*.json"))))
def test_shipped_configs_do_not_warn(path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert validate_args(json.load(open(path)), source=path) == []
        load_args(pathlib.Path(path).stem, config_dir=str(ROOT / "configs"))
    assert KNOWN_KEYS == JAX_KNOWN_KEYS | {"norm_impl", "rng"}
