"""The port's draft distillation (``train/distill.py``) and ``randint``
(``engine/prng.py``) against the JAX package, on the CPU.

- ``prng.randint`` bit-equal to ``jax.random.randint`` over shapes and
  ranges (hypothesis), empty and inverted ranges, array bounds.
- ``rollout_corpus`` token-equal to JAX's on the permutation weights of
  ``testing/modelgen.py``: greedy and sampled at temperature 0.8 (the
  port's threefry draws), uniform prefixes and a prefix pool.
- ``distill_loss`` (loss, kl, ce, agreement) on random fp32 weights
  within ``TOL`` of JAX's; the gradient of every leaf against
  ``jax.grad`` within ``GRAD_TOL`` of its scale.
- ``_adam_update``, ``_lr_at`` and three ``_train_step``s from the same
  params: losses within ``TOL``, params within ``PARAM_TOL`` (Adam's
  m / sqrt(v) turns a gradient element near zero into a step of about
  the learning rate whose sign fp32 noise may flip).
- ``draft_config_for`` equal field by field; a checkpoint either package
  writes loads in the other, tensor for tensor.
- A whole ``distill_draft`` run from the same permutation teacher and the
  same initial draft weights (injected into the JAX trainer through
  ``monkeypatch`` of its ``T.init_params``, its batch rows through its
  numpy generator): losses and agreement within tolerance, the saved
  checkpoints within ``PARAM_TOL``.
- The CLI's ``distill-draft`` parses every JAX flag to the same values
  and writes a checkpoint the JAX package loads; without CUDA and without
  ``--device cpu`` it exits 2.
- ``PrefillAttention`` (kernel A's autograd seam) gives the plain
  function's gradient.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from crowdllama_tpu.engine import weights as jw  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu.models.config import get_config as j_get_config  # noqa: E402
from crowdllama_tpu.train import distill as jd  # noqa: E402
from crowdllama_tpu_torch.engine import prng  # noqa: E402
from crowdllama_tpu_torch.engine import weights as tw  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402
from crowdllama_tpu_torch.train import distill as td  # noqa: E402

#: loss, kl, ce (fp32 sums of a few thousand terms, orders apart)
TOL = 1e-5
#: a gradient leaf's max abs difference over its max abs value
GRAD_TOL = 1e-4
#: params after Adam steps at lr 3e-3 (see the module docstring)
PARAM_TOL = 2e-4
CTX = 64


def _jparams(flat):
    out: dict = {}
    for name, arr in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _cfgs(**kw):
    return (j_get_config("tiny-test", max_context_length=CTX, **kw),
            get_config("tiny-test", max_context_length=CTX, **kw))


def _perm_flat():
    from crowdllama_tpu.testing.modelgen import permutation_params

    return jw._flatten_params(permutation_params(_cfgs()[0]))


def _random_flat(layers=2, seed=1):
    jcfg = _cfgs(num_layers=layers)[0]
    return jw._flatten_params(JT.init_params(jcfg, jax.random.PRNGKey(seed),
                                             dtype=jnp.float32))


# ----------------------------------------------------------------- randint

@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       shape=st.lists(st.integers(1, 5), min_size=1, max_size=3),
       lo=st.integers(-2**31, 2**31 - 1), width=st.integers(-5, 2**32))
def test_randint_bit_equal_to_jax(seed, shape, lo, width):
    hi = max(-2**31, min(2**31 - 1, lo + width))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, tuple(shape), lo, hi))
    got = prng.randint(np.asarray(key), tuple(shape), lo, hi)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 512), (4, 33), (0, 32000), (7, 7),
                                   (9, 3), (0, 1)])
def test_randint_serving_ranges_and_array_bounds(lo, hi):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        prng.randint(np.asarray(key), (16, 8), lo, hi),
        np.asarray(jax.random.randint(key, (16, 8), lo, hi)))
    los, his = np.arange(6) + lo, np.arange(6) * 3 + hi
    np.testing.assert_array_equal(
        prng.randint(np.asarray(key), (6,), los, his),
        np.asarray(jax.random.randint(key, (6,), los, his)))


# ------------------------------------------------------------------ corpus

@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("pool", [False, True], ids=["uniform", "pool"])
def test_rollout_corpus_token_equal_to_jax(temperature, pool):
    jcfg, tcfg = _cfgs()
    flat = _perm_flat()
    prefix_pool = (np.arange(300, dtype=np.int32) * 7) % 512 if pool else None
    key = jax.random.PRNGKey(5)
    want = jd.rollout_corpus(jcfg, _jparams(flat), key, 6, 24, temperature,
                             prefix_pool=prefix_pool, max_prefix=8)
    got = td.rollout_corpus(tcfg, tw.params_from_numpy(flat),
                            np.asarray(key), 6, 24, temperature,
                            prefix_pool=prefix_pool, max_prefix=8)
    assert got.shape == (6, 24) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_corpus_from_text_equal_to_jax(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(bytes(range(256)) * 3 + b"tail")
    np.testing.assert_array_equal(td.corpus_from_text(str(p), 100, 32),
                                  jd.corpus_from_text(str(p), 100, 32))
    short = tmp_path / "short.txt"
    short.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too short"):
        td.corpus_from_text(str(short), 100, 32)


# ---------------------------------------------------------- loss and grads

def _batch(seed=0, b=4, t=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (b, t)).astype(np.int32)
    teacher = (rng.standard_normal((b, t, 512)) * 3).astype(np.float32)
    return tokens, teacher


@pytest.mark.parametrize("kl_weight,tau", [(0.5, 2.0), (1.0, 1.0),
                                           (0.0, 3.0)])
def test_distill_loss_matches_jax(kl_weight, tau):
    jcfg, tcfg = _cfgs(num_layers=2)
    flat = _random_flat()
    tokens, teacher = _batch()
    lj, auxj = jd.distill_loss(_jparams(flat), jcfg, jnp.asarray(teacher),
                               jnp.asarray(tokens), kl_weight, tau)
    lt, auxt = td.distill_loss(tw.params_from_numpy(flat), tcfg,
                               torch.from_numpy(teacher),
                               torch.from_numpy(tokens).long(), kl_weight,
                               tau)
    np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
    for a, b in zip(auxt, auxj):
        np.testing.assert_allclose(float(a), float(b), rtol=TOL, atol=TOL)


def test_distill_gradient_matches_jax_grad():
    jcfg, tcfg = _cfgs(num_layers=2)
    flat = _random_flat()
    tokens, teacher = _batch(1)
    want = jw._flatten_params(jax.grad(lambda p: jd.distill_loss(
        p, jcfg, jnp.asarray(teacher), jnp.asarray(tokens), 0.5, 2.0)[0])(
            _jparams(flat)))
    params = td._tree_map(lambda x: x.requires_grad_(),
                          tw.params_from_numpy(flat))
    loss, _ = td.distill_loss(params, tcfg, torch.from_numpy(teacher),
                              torch.from_numpy(tokens).long(), 0.5, 2.0)
    got = tw.flatten_params(td._unflatten(
        params, torch.autograd.grad(loss, td._leaves(params))))
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        assert np.abs(got[k] - w).max() <= GRAD_TOL * scale, k


def test_prefill_attention_function_gives_the_plain_gradient(monkeypatch):
    """``PrefillAttention``'s backward: the plain function's gradient at
    the saved inputs (its forward stands in for the kernel here)."""
    from crowdllama_tpu_torch.ops.attention import prefill_attention_ref
    from crowdllama_tpu_torch.ops.cuda import flash

    def plain(q, k, v, pos, scale, softcap, window, kv_valid):
        return prefill_attention_ref(q, k, v, pos, scale, softcap=softcap,
                                     sliding_window=window,
                                     kv_valid=kv_valid)

    monkeypatch.setattr(flash, "_launch_prefill", plain)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 12, 8, 64), generator=gen)
    k = torch.randn((2, 2, 12, 64), generator=gen)
    v = torch.randn((2, 2, 12, 64), generator=gen)
    pos = torch.arange(12, dtype=torch.int32)[None].repeat(2, 1)
    valid = torch.ones((2, 12), dtype=torch.bool)
    valid[1, 10:] = False
    g = torch.randn((2, 12, 8, 64), generator=gen)
    for softcap, window, kv in ((0.0, 0, None), (30.0, 5, valid)):
        a = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash.PrefillAttention.apply(*a, pos, 0.125, softcap, window,
                                           kv)
        got = torch.autograd.grad(out, a, g)
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(
            plain(*b, pos, 0.125, softcap, window, kv), b, g)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    # Only the inputs that ask get a gradient.
    a = [q.clone().requires_grad_(), k.clone(), v.clone()]
    out = flash.PrefillAttention.apply(*a, pos, 0.125, 0.0, 0, None)
    (gq,) = torch.autograd.grad(out, [a[0]], g)
    assert gq.shape == q.shape


# --------------------------------------------------------------- optimizer

def test_adam_update_matches_jax():
    flat = _random_flat()
    rng = np.random.default_rng(2)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.01
             for k, v in flat.items()}
    jopt = jd._adam_init(_jparams(flat))
    topt = td._adam_init(tw.params_from_numpy(flat))
    jp, tp = _jparams(flat), tw.params_from_numpy(flat)
    for lr in (1e-3, 3e-3):
        jp, jopt = jd._adam_update(_jparams(grads), jopt, jp,
                                   jnp.float32(lr))
        tp, topt = td._adam_update(tw.params_from_numpy(grads), topt, tp,
                                   np.float32(lr))
    assert topt["t"] == int(jopt["t"]) == 2
    for name, j, t in (("params", jp, tp), ("m", jopt["m"], topt["m"]),
                       ("v", jopt["v"], topt["v"])):
        jf, tf = jw._flatten_params(j), tw.flatten_params(t)
        for k in jf:
            np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, atol=1e-9,
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("total,warmup", [(10, 0.1), (1200, 0.1), (30, 0.5),
                                          (5, 0.0)])
def test_lr_schedule_matches_jax(total, warmup):
    for step in sorted({0, 1, 2, total // 3, total // 2, total - 1, total,
                        total + 3}):
        want = float(jd._lr_at(jnp.asarray(step), total, 3e-3, warmup))
        got = float(td._lr_at(step, total, 3e-3, warmup))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_three_train_steps_match_jax():
    jcfg, tcfg = _cfgs(num_layers=2)
    flat = _random_flat()
    tokens, teacher = _batch(3)
    jp, tp = _jparams(flat), tw.params_from_numpy(flat)
    jopt, topt = jd._adam_init(jp), td._adam_init(tp)
    for _ in range(3):
        jp, jopt, lj, auxj = jd._train_step(
            jp, jopt, jcfg, jnp.asarray(teacher), jnp.asarray(tokens), 10,
            3e-3, 0.1, 0.5, 2.0)
        tp, topt, lt, auxt = td._train_step(
            tp, topt, tcfg, torch.from_numpy(teacher),
            torch.from_numpy(tokens).long(), 10, 3e-3, 0.1, 0.5, 2.0)
        np.testing.assert_allclose(float(lt), float(lj), rtol=TOL)
        np.testing.assert_allclose([float(x) for x in auxt],
                                   [float(x) for x in auxj], rtol=TOL,
                                   atol=TOL)
    jf, tf = jw._flatten_params(jp), tw.flatten_params(tp)
    for k in jf:
        assert np.abs(tf[k] - jf[k]).max() <= PARAM_TOL, k


# ------------------------------------------------------ config, checkpoint

@pytest.mark.parametrize("model,layers,ctx", [("tiny-test", 1, 0),
                                              ("tiny-test", 2, 128),
                                              ("tinyllama-1.1b", 2, 0),
                                              ("llama-3-8b", 3, 4096)])
def test_draft_config_for_matches_jax(model, layers, ctx):
    want = dataclasses.asdict(jd.draft_config_for(j_get_config(model),
                                                  layers, ctx))
    got = dataclasses.asdict(td.draft_config_for(get_config(model), layers,
                                                 ctx))
    assert got == want


def _smoke(out, **kw):
    return td.DistillConfig(teacher="tiny-test", steps=12, batch=8,
                            seq_len=32, corpus_seqs=16, out=str(out),
                            log_every=0, device="cpu", **kw)


def test_checkpoints_load_across_packages(tmp_path):
    res = td.distill_draft(_smoke(tmp_path / "torch"))
    assert res["losses"][-1] < res["losses"][0]
    cfg = jw.native_config_from_dir(res["checkpoint"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        res["draft_config"])
    loaded = jw._flatten_params(jw.load_or_init_params(
        cfg, res["checkpoint"], dtype=jnp.float32))
    mine = tw.flatten_params(res["draft_params"])
    assert set(loaded) == set(mine)
    for k in mine:
        np.testing.assert_array_equal(loaded[k], mine[k], err_msg=k)

    jres = jd.distill_draft(jd.DistillConfig(
        teacher="tiny-test", steps=4, batch=4, seq_len=16, corpus_seqs=4,
        out=str(tmp_path / "jax"), log_every=0))
    tcfg = tw.native_config_from_dir(jres["checkpoint"])
    back = tw.flatten_params(tw.load_or_init_params(
        tcfg, jres["checkpoint"], dtype=torch.float32))
    for k, v in jw._flatten_params(jres["draft_params"]).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


class _Rows:
    """The port's batch rows (a ``torch.Generator`` seeded with the run's
    seed) behind numpy's ``Generator.choice``, for the JAX trainer."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def choice(self, n, size, replace):
        if replace:
            return torch.randint(n, (size,), generator=self.gen).numpy()
        return torch.randperm(n, generator=self.gen)[:size].numpy()


def test_whole_run_matches_jax(tmp_path, monkeypatch):
    jcfg, tcfg = _cfgs()
    flat = _perm_flat()
    dc = _smoke(tmp_path / "torch", seed=3)
    res = td.distill_draft(dc, teacher_cfg=tcfg,
                           teacher_params=tw.params_from_numpy(flat))
    init = tw.flatten_params(td.init_draft_params(
        res["draft_config"], td.distill_keys(dc.seed)[2], "cpu"))
    monkeypatch.setattr(jd.T, "init_params",
                        lambda cfg, key, dtype: _jparams(init))
    monkeypatch.setattr(jd, "np", types.SimpleNamespace(
        **{k: getattr(np, k) for k in ("frombuffer", "uint8", "int32",
                                       "concatenate", "asarray", "stack",
                                       "ndarray")},
        random=types.SimpleNamespace(default_rng=_Rows)))
    jres = jd.distill_draft(jd.DistillConfig(
        teacher="tiny-test", steps=dc.steps, batch=dc.batch,
        seq_len=dc.seq_len, corpus_seqs=dc.corpus_seqs, seed=dc.seed,
        out=str(tmp_path / "jax"), log_every=0), teacher_cfg=jcfg,
        teacher_params=_jparams(flat))
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-4)
    # agreement: the student's argmax may tie differently at one position
    assert abs(res["agreement"] - jres["agreement"]) <= 1 / (8 * 31) + 1e-6
    got = tw.flatten_params(tw.load_native_params(
        tw.native_config_from_dir(res["checkpoint"]), res["checkpoint"],
        dtype=torch.float32))
    want = jw._flatten_params(jres["draft_params"])
    for k in want:
        assert np.abs(got[k] - np.asarray(want[k])).max() <= PARAM_TOL, k


# --------------------------------------------------------------------- CLI

DISTILL_ARGV = ["distill-draft", "--teacher", "tiny-test", "--teacher-path",
                "", "--out", "OUT", "--draft-layers", "1", "--steps", "6",
                "--batch", "4", "--seq-len", "16", "--corpus-seqs", "4",
                "--max-prefix", "8", "--sample-temperature", "0.5",
                "--no-tie-embeddings", "--lr", "0.001", "--kl-weight",
                "0.25", "--kl-temperature", "1.5", "--seed", "7"]


def test_cli_distill_draft_parses_like_jax():
    from crowdllama_tpu.cli.main import build_parser as jparser
    from crowdllama_tpu_torch.cli.main import build_parser

    for argv in (DISTILL_ARGV, ["distill-draft", "--out", "x"]):
        want = vars(jparser().parse_args(argv))
        got = vars(build_parser().parse_args(argv))
        assert {k: got[k] for k in want} == want
        assert got["device"] == "cuda"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["distill-draft"])  # --out is required


def test_cli_distill_draft_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    from crowdllama_tpu_torch.cli import main as cli

    out = tmp_path / "ckpt"
    argv = [a if a != "OUT" else str(out) for a in DISTILL_ARGV]
    results, run = [], td.distill_draft

    def recorded(dc):
        results.append(run(dc))
        return results[-1]

    monkeypatch.setattr(td, "distill_draft", recorded)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"checkpoint: {out}"
    assert lines[1].startswith("final loss: ")
    assert "--spec-decode draft --spec-draft-path" in lines[2]
    cfg = jw.native_config_from_dir(out)
    assert cfg.num_layers == 1
    jw.load_or_init_params(cfg, str(out), dtype=jnp.float32)
    (rep,) = results
    assert rep["checkpoint"] == str(out)
    assert len(rep["losses"]) == len(rep["step_ms"]) == 6
    assert rep["rollout_tokens"] == 4 * 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
