"""Gemma-2-9b's configuration (head dim 256) on the CPU, without weights.

Google's published ``config.json`` for ``google/gemma-2-9b`` is written
into ``tmp_path``; both packages' ``config_from_hf_dir`` must read the
same ``ModelConfig``, field by field, with head dim 256, attention scaled
by ``query_pre_attn_scalar`` 256 and a sliding window of 4,096 on every
other layer (``layer_sliding_windows`` of both packages).  The
configuration ``chip_smoke.py`` serves on the card (the port's
``gemma-2-27b`` entry widened by ``dataclasses.replace``) must be that
configuration too, and the directory its distillation teacher reads
(the file with ``tie_word_embeddings`` stated) must give it.  The
published dict lives in ``testing/hf_fixtures.py``, which the smoke
reads too.
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
from crowdllama_tpu_torch.testing import hf_fixtures as hf  # noqa: E402

GEMMA2_9B = hf.GEMMA2_9B_CONFIG


@pytest.fixture
def configs(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(GEMMA2_9B))
    return JW.config_from_hf_dir(tmp_path), TW.config_from_hf_dir(tmp_path)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_both_packages_read_gemma2_9b_alike(configs):
    jcfg, cfg = configs
    jf, tf = _fields(jcfg), _fields(cfg)
    assert jf.keys() == tf.keys()
    for name in tf:
        assert tf[name] == jf[name], name
    assert cfg.family == "gemma2"
    assert cfg.resolved_head_dim() == jcfg.resolved_head_dim() == 256
    assert (cfg.num_heads, cfg.num_kv_heads) == (16, 8)
    assert T.attn_scale(cfg) == JT.attn_scale(jcfg) == 256 ** -0.5


def test_gemma2_9b_windows_every_other_layer(configs):
    jcfg, cfg = configs
    got = T.layer_sliding_windows(cfg)
    assert got == np.asarray(JT.layer_sliding_windows(jcfg)).tolist()
    assert got == [4096 if i % 2 == 0 else 0 for i in range(42)]


def test_chip_smoke_serves_the_published_configuration(configs):
    import chip_smoke

    _, cfg = configs
    smoke = chip_smoke.gemma2_9b_config()
    # The published file has no tie_word_embeddings key: Gemma2Config
    # defaults it to true, while both packages' loaders read a missing key
    # as false (ROADMAP Queue 3 item 21).  The card serves the tied model.
    skip = {"name", "tie_word_embeddings"}
    for name, value in _fields(cfg).items():
        if name not in skip:
            assert getattr(smoke, name) == value, name
    assert smoke.tie_word_embeddings
    assert smoke.param_count() == pytest.approx(9.24e9, rel=0.01)


def test_distill_teacher_directory_reads_as_the_served_model(tmp_path):
    """The card's ``distill_gemma2_9b`` teacher directory (the published
    file with Hugging Face's ``tie_word_embeddings`` default stated) reads
    alike in both packages, tied, and under the teacher's name it is
    ``chip_smoke.gemma2_9b_config`` field by field."""
    import chip_smoke

    (tmp_path / "config.json").write_text(
        json.dumps(hf.GEMMA2_9B_TIED_CONFIG))
    jcfg, cfg = JW.config_from_hf_dir(tmp_path), TW.config_from_hf_dir(
        tmp_path)
    assert _fields(jcfg) == _fields(cfg) and cfg.tie_word_embeddings
    served = TW.resolve_model_config(chip_smoke.GEMMA9, str(tmp_path))
    assert _fields(served) == _fields(chip_smoke.gemma2_9b_config())
    assert hf.GEMMA2_9B_TIED_CONFIG == {**GEMMA2_9B,
                                        "tie_word_embeddings": True}
