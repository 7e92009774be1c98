"""H2O-Danube-1.8B's configuration (head dim 80) on the CPU, without
weights.

The published ``config.json`` of ``h2oai/h2o-danube-1.8b-base``
(``testing/hf_fixtures.py DANUBE_1_8B_CONFIG``) is written into
``tmp_path``; both packages' ``config_from_hf_dir`` must read the same
``ModelConfig``, field by field: a Mistral model with head dim 80 (hidden
2,560 over 32 query heads, 8 kv heads), scaled by 80 ** -0.5, and a
sliding window of 4,096 on all 24 layers (``layer_sliding_windows`` of
both packages).  The configuration ``chip_smoke.py`` serves on the card
(read from the same dict written out as a ``config.json``) must be that
configuration, at ~1.83 B parameters.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from crowdllama_tpu.engine import weights as JW  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu_torch.engine import weights as TW  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.ops.cuda import HEAD_DIMS  # noqa: E402
from crowdllama_tpu_torch.testing import hf_fixtures as hf  # noqa: E402

DANUBE = hf.DANUBE_1_8B_CONFIG


@pytest.fixture
def configs(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(DANUBE))
    return JW.config_from_hf_dir(tmp_path), TW.config_from_hf_dir(tmp_path)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_both_packages_read_danube_alike(configs):
    jcfg, cfg = configs
    jf, tf = _fields(jcfg), _fields(cfg)
    assert jf.keys() == tf.keys()
    for name in tf:
        assert tf[name] == jf[name], name
    assert cfg.family == "mistral"
    assert cfg.resolved_head_dim() == jcfg.resolved_head_dim() == 80
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.num_layers) == (32, 8, 24)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size) == (
        32000, 2560, 6912)
    assert cfg.max_context_length == 16384 and not cfg.tie_word_embeddings
    assert T.attn_scale(cfg) == JT.attn_scale(jcfg) == 80 ** -0.5
    # Every attention kernel of the port is compiled at Danube's head dim.
    assert cfg.resolved_head_dim() in HEAD_DIMS


def test_danube_windows_every_layer(configs):
    jcfg, cfg = configs
    got = T.layer_sliding_windows(cfg)
    assert got == np.asarray(JT.layer_sliding_windows(jcfg)).tolist()
    assert got == [4096] * 24


def test_chip_smoke_serves_the_published_configuration(configs):
    import chip_smoke

    _, cfg = configs
    smoke = chip_smoke.danube_config()
    for name, value in _fields(cfg).items():
        if name != "name":
            assert getattr(smoke, name) == value, name
    assert smoke.name == chip_smoke.DANUBE
    assert smoke.param_count() == pytest.approx(1.83e9, rel=0.01)
