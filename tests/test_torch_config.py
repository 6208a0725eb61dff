"""The port's config and YAML reader against the JAX package and PyYAML.

Inputs: the two example configs and the config text of
`tests/test_pipeline_e2e.py`. `Config.from_dict` of the same mapping gives
the same dataclasses field by field (values and their types), the same
`model_kwargs()` and the same TTA mirror axes; the port's reader gives
what `yaml.safe_load` gives on those texts and on edge cases, and raises
on the YAML it does not read.
"""

import dataclasses
import json
import math
import os
import re
import sys

import pytest
import yaml

from waveformer_tpu import config as jcfg
from waveformer_tpu_torch import config as tcfg
from waveformer_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _e2e_config_text():
    """The config the pipeline e2e test writes, with its paths filled in."""
    src = _read("tests", "test_pipeline_e2e.py")
    text = re.search(r'f\.write\(f"""\\\n(.*?)"""\)', src, re.S).group(1)
    for name, value in (("fullres", "/data/fullres"), ("work", "/work"),
                        ("brats_raw", "/data/raw")):
        text = text.replace("{" + name + "}", value)
    assert "{" not in text
    return text


CONFIG_TEXTS = {
    "brats2023": _read("examples", "brats2023", "config.yaml"),
    "abdomen_ct": _read("examples", "abdomen_ct", "config.yaml"),
    "pipeline_e2e": _e2e_config_text(),
}

EDGE_TEXTS = {
    "numbers": "a: 1\nb: 1.5\nc: .5\nd: -.5\ne: 1e-4\nf: 1.0e-4\ng: 1.e+3\nh: 0x1F\n"
               "i: 0o7\nj: 017\nk: 08\nl: 0b101\nm: 1_000\nn: +3\no: -0\np: 6.02e23\n"
               "q: .inf\nr: -.Inf\ns: 1.\n",
    "bools_nulls": "a: yes\nb: No\nc: on\nd: OFF\ne: true\nf: False\ng: ~\nh: null\ni:\n"
                   "j: NULL\nk: Null\nl: nul\nm: y\n",
    "quotes": "a: 'it''s: # not a comment'\nb: \"x: y # z\"  # a comment\nc: plain # c\n"
              "d: a#b\ne: ''\nf: \"\"\ng: \"\\u00e9\\t\\n\\\\ \\\"q\\\"\"\nh: '#'\n"
              "i: it's\nj: don't # c\nk: http://x.y/z:8\n\"quoted key\": 1\n'k2': x\n",
    "nesting": "# top\n\nnet:\n  t:\n    dims: [8, 16, [1, 2], 'a, b', \"c]\", []]  # c\n"
               "    e: []\n\n  u: 2\nv:\nw: 3\n",
    "flow_across_lines": "a: [1,\n  2, # two\n  3]\nb: [x, [y,\n  z]]\n",
    "scalar_keys": "1: one\ntrue: t\n1.5: f\nnull: n\n",
    "document_start": "---\na: 1\n",
    "duplicate_keys": "a: b\na: c\n",
    "empty": "",
    "only_comments": "# one\n  # two\n",
    "nested_scalar": "key:\n  scalar_below\n",
}

BAD_TEXTS = {
    "anchor": "a: &x 1\nb: *x\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "literal_block": "a: |\n  x\n",
    "folded_block": "a: >\n  x\n",
    "flow_mapping": "a: {b: 1}\n",
    "mapping_in_flow_list": "a: [b: 1]\n",
    "two_documents": "a: 1\n---\nb: 2\n",
    "document_end": "a: 1\n...\n",
    "directive": "%YAML 1.1\n---\na: 1\n",
    "complex_key": "? a\n: b\n",
    "timestamp": "a: 2001-12-14\n",
    "sexagesimal": "a: 1:30\n",
    "merge_key": "<<: 1\n",
    "nested_mapping_value": "a: b: c\n",
    "multi_line_quoted": "a: 'x\n  y'\n",
    "multi_line_plain": "a: x\n  y\n",
    "unterminated_flow": "a: [1, 2\n",
    "tab_indent": "a:\n\tb: 1\n",
    "block_sequence": "a:\n  - 1\n  - 2\n",
    "block_sequence_at_key_indent": "a:\n- 1\nb: 2\n",
    "top_level_sequence": "- 1\n- 2\n",
    "mapping_in_sequence": "- a: 1\n",
    "empty_flow_entry": "a: [1,,2]\n",
    "bad_indent": "a:\n  b: 1\n c: 2\n",
}


def _same(got, want):
    """Equal values of equal types, NaN included, recursively."""
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if type(got) is not type(want):
        return False
    if isinstance(want, dict):
        return list(got) == list(want) and all(_same(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
    return got == want


# fields the port's dataclasses add after the JAX package's (the models only
# the port builds); the JAX configs leave them at their defaults
PORT_ONLY = {"NetworkConfig": ("feature_size", "window_size", "use_v2")}


def _assert_fields_equal(got, want, path="Config"):
    assert type(got).__name__ == type(want).__name__, path
    names = [f.name for f in dataclasses.fields(want)]
    extra = PORT_ONLY.get(type(got).__name__, ())
    assert [f.name for f in dataclasses.fields(got)] == names + list(extra), path
    defaults = {f.name: f.default for f in dataclasses.fields(got)}
    for name in extra:
        assert getattr(got, name) == defaults[name], f"{path}.{name}"
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(b):
            _assert_fields_equal(a, b, f"{path}.{name}")
        else:
            assert _same(a, b), (f"{path}.{name}", a, b)


@pytest.mark.parametrize("name", CONFIG_TEXTS)
def test_from_dict_matches_jax(name):
    raw = yaml.safe_load(CONFIG_TEXTS[name])
    got, want = tcfg.Config.from_dict(raw), jcfg.Config.from_dict(raw)
    _assert_fields_equal(got, want)
    assert got.network.model_kwargs() == want.network.model_kwargs()
    for n in (1, 2, 4, 8):
        g = dataclasses.replace(got.prediction, tta_orientations=n)
        w = dataclasses.replace(want.prediction, tta_orientations=n)
        assert g.effective_mirror_axes() == w.effective_mirror_axes()
    assert got.prediction.effective_mirror_axes() == want.prediction.effective_mirror_axes()


def test_defaults_and_filtering_match_jax():
    _assert_fields_equal(tcfg.Config(), jcfg.Config())
    assert tcfg.PredictionConfig._TTA_TO_AXES == jcfg.PredictionConfig._TTA_TO_AXES
    raw = {"label_mode": "multiclass", "unknown_top": [1, 2], "roi_size": 64,
           "prediction": {"tta_orientations": 4, "bogus": 1, "patch_size": 64,
                          "mirror_axes": [2]},
           "logging": {"enabled": False, "bogus": 2},
           "network": {"img_size": 64, "bogus": 3, "transformer": {"depths": [1, 1, 1, 1],
                                                                   "bogus": 4}}}
    got, want = tcfg.Config.from_dict(raw), jcfg.Config.from_dict(raw)
    _assert_fields_equal(got, want)
    assert got.extra == {"label_mode": "multiclass", "unknown_top": [1, 2]}
    with pytest.raises(ValueError, match="1/2/4/8"):
        tcfg.PredictionConfig(tta_orientations=3)


def test_swin_unetr_network_config():
    """The port's own model type: its fields from a mapping, its model's
    keyword arguments, and no check of WaveFormer's wavelet levels."""
    net = tcfg.NetworkConfig.from_dict({
        "model_type": "SwinUNETR", "in_channels": 4, "out_channels": 3, "img_size": 96,
        "feature_size": 48, "window_size": 7, "use_v2": True,
        "transformer": {"depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
                        "decom_levels": [9, 9, 9, 9], "drop_path_rate": 0.0}})
    assert net.model_kwargs() == {
        "img_size": (96, 96, 96), "in_channels": 4, "out_channels": 3, "feature_size": 48,
        "depths": (2, 2, 2, 2), "num_heads": (3, 6, 12, 24), "window_size": 7,
        "use_v2": True, "drop_path_rate": 0.0}
    with pytest.raises(ValueError, match="not divisible"):
        tcfg.NetworkConfig.from_dict({"transformer": {"decom_levels": [9, 9, 9, 9]}})
    with pytest.raises(ValueError, match="patches of 2"):
        tcfg.NetworkConfig(model_type="SwinUNETR", patch_size=4)


@pytest.mark.parametrize("name", CONFIG_TEXTS)
def test_load_config_without_pyyaml(name, tmp_path, monkeypatch):
    path = tmp_path / "config.yaml"
    path.write_text(CONFIG_TEXTS[name])
    want = jcfg.load_config(str(path))
    as_json = tmp_path / "config.json"
    as_json.write_text(json.dumps(yaml.safe_load(CONFIG_TEXTS[name])))
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` now fails
    _assert_fields_equal(tcfg.load_config(str(path)), want)
    _assert_fields_equal(tcfg.load_config(str(as_json)), want)


@pytest.mark.parametrize("name", list(CONFIG_TEXTS) + list(EDGE_TEXTS))
def test_reader_matches_pyyaml(name):
    text = CONFIG_TEXTS.get(name, EDGE_TEXTS.get(name))
    want = yaml.safe_load(text)
    got = yaml_subset.safe_load(text)
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("name", BAD_TEXTS)
def test_reader_raises_on_unsupported_yaml(name):
    with pytest.raises(ValueError):
        yaml_subset.safe_load(BAD_TEXTS[name])
