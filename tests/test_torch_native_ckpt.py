"""Native checkpoints (``engine/weights.py``) and the permutation weights
(``testing/modelgen.py``) of the port against the JAX package.

- JAX's ``save_params`` read by the port's ``load_native_params`` and the
  port's ``save_params`` read by JAX's, bf16 and fp32 weights: every
  tensor bit-equal; ``native_config_from_dir`` gives the same config.
- The port's safetensors reader on a file the ``safetensors`` package
  writes (F32, BF16, I32), and the bytes it writes read back by that
  package.
- An HF checkpoint directory (config.json without the marker, and
  safetensors) is refused by ``load_native_params`` as not native, and
  accepted as a ``spec_draft_path``; no directory at all is refused by
  both; a shape that does not match the config is refused.
- The port's permutation weights: the JAX embeddings and unembedding,
  and greedy decode walking the cycle (every argmax its successor).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine import weights as jw  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu_torch.config import Configuration  # noqa: E402
from crowdllama_tpu_torch.engine import weights as tw  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.testing import modelgen  # noqa: E402

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp32": (jnp.float32, torch.float32)}


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_checkpoint_loads_in_the_port(tmp_path, dtype):
    jd, td = DTYPES[dtype]
    jcfg = j_get_config("tiny-test")
    params = JT.init_params(jcfg, jax.random.PRNGKey(3), dtype=jd)
    jw.save_params(jcfg, params, tmp_path / "c", {"note": "x"})
    assert tw.is_native_checkpoint(tmp_path / "c")
    cfg = tw.native_config_from_dir(tmp_path / "c")
    assert cfg == get_config("tiny-test")
    got = tw.load_native_params(cfg, tmp_path / "c", dtype=td)
    flat = tw.flatten_params(got)
    want = jw._flatten_params(params)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_loads_in_jax(tmp_path, dtype):
    jd, td = DTYPES[dtype]
    cfg = get_config("tiny-test", max_context_length=96)
    params = tw.init_params(cfg, seed=4, dtype=td)
    tw.save_params(cfg, params, tmp_path / "c")
    jcfg = jw.native_config_from_dir(tmp_path / "c")
    assert jcfg == j_get_config("tiny-test", max_context_length=96)
    got = jw._flatten_params(jw.load_native_params(jcfg, tmp_path / "c",
                                                   dtype=jd))
    want = tw.flatten_params(params)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # Read back by the port itself: byte-equal in its own dtype.
    back = tw.load_native_params(cfg, tmp_path / "c", dtype=td)
    for k, v in tw.flatten_params(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_safetensors_reader_and_writer_agree_with_the_package(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    tensors = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
               "b": (torch.arange(6, dtype=torch.float32) / 3).to(
                   torch.bfloat16).reshape(2, 3),
               "c": torch.tensor([[-5, 7]], dtype=torch.int32)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = tw.read_safetensors(tmp_path / "x.safetensors")
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    arrays = {"w": np.linspace(-1, 1, 10, dtype=np.float32).reshape(2, 5),
              "i": np.array([3, -4], np.int64)}
    tw.write_safetensors(arrays, tmp_path / "y.safetensors")
    back = load_file(str(tmp_path / "y.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("layout", ["hf", "missing"])
def test_non_native_directories_are_refused_naming_item_9(tmp_path,
                                                           layout):
    # HF checkpoints are served now (ROADMAP Queue 1 item 9a): an HF
    # directory is no native checkpoint, but is a draft checkpoint.
    from crowdllama_tpu_torch.models.convert import hf_state_dict

    cfg = get_config("tiny-test")
    path = tmp_path / "d"
    if layout == "hf":
        tw.save_hf_checkpoint(
            hf_state_dict(cfg, tw.init_params(cfg, dtype=torch.float32)),
            {"architectures": ["LlamaForCausalLM"], "model_type": "llama"},
            path, shards=2)
        assert tw.is_hf_checkpoint(path)
    assert not tw.is_native_checkpoint(path)
    with pytest.raises(ValueError, match="not a native checkpoint") as e:
        tw.load_native_params(cfg, path)
    assert "item 9" not in str(e.value)
    if layout == "hf":
        c = Configuration.from_environment(spec_decode="draft",
                                           spec_draft_path=str(path))
        assert c.spec_draft_path == str(path)
    else:
        with pytest.raises(ValueError, match="not a checkpoint directory"):
            Configuration.from_environment(spec_decode="draft",
                                           spec_draft_path=str(path))


def test_shape_mismatch_is_refused(tmp_path):
    cfg = get_config("tiny-test")
    tw.save_params(cfg, tw.init_params(cfg, dtype=torch.float32),
                   tmp_path / "c")
    with pytest.raises(ValueError, match="shape"):
        tw.load_native_params(get_config("tiny-test", hidden_size=32),
                              tmp_path / "c")


def test_permutation_weights_match_jax_and_walk_the_cycle(tmp_path):
    from crowdllama_tpu.testing.modelgen import permutation_params

    cfg = get_config("tiny-test", max_context_length=64)
    want = jw._flatten_params(permutation_params(
        j_get_config("tiny-test", max_context_length=64)))
    got = modelgen.permutation_params(cfg)
    for k in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(_as_np(got[k]), want[k], err_msg=k)
    assert not got["layers"]["wo"].any() and not got["layers"]["w_down"].any()
    nxt = modelgen.permutation_next(cfg.vocab_size)
    assert sorted(nxt[:256]) == list(range(1, 256)) + [259]
    path = modelgen.permutation_checkpoint("tiny-test", tmp_path / "p",
                                           max_context=64, layers=1)
    jcfg = jw.native_config_from_dir(path)
    assert jcfg.num_layers == 1
    jw.load_native_params(jcfg, path, dtype=jnp.float32)
