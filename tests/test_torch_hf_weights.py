"""HF checkpoints: the port's config derivation, loader and converter
against the JAX package's, and an engine serving an HF directory.

- ``config_from_hf_dir`` / ``resolve_model_config`` equal JAX's on the
  ``config.json``s ``transformers`` writes for Llama (plain, llama3 and
  linear rope scaling), Mistral (sliding window), Qwen2, Qwen3, Gemma-2
  and Mixtral; an unsupported rope type (yarn) raises in both.
- ``load_safetensors_params`` / ``params_from_hf`` on ``save_pretrained``
  directories of tiny random models (the ``tiny-test*`` widths) are
  ``torch.equal`` to JAX's output passed through numpy: fp32 and bf16 on
  disk, one file and sharded through an index.
- Prefill logits of the loaded fp32 weights match the HF model and JAX's
  ``T.prefill`` at ``atol=8e-3``, as ``test_model_parity.py`` holds JAX.
- Greedy streams of ``TorchEngine(model=<a name not in the registry>,
  model_path=dir)`` equal ``JaxEngine``'s on the same directory (its
  tokenizer and chat template included), paged and contiguous; the
  directory holds the permutation weights (``testing/modelgen.py``), two
  shards and an index.
- A draft runner on an HF ``spec_draft_path`` and
  ``GatewayDrafter.from_checkpoint`` on an HF directory give JAX's tokens.
- A Mixtral directory raises, naming ROADMAP Queue 1 item 7.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from crowdllama_tpu.engine import weights as jw  # noqa: E402
from crowdllama_tpu.models import transformer as JT  # noqa: E402
from crowdllama_tpu_torch.engine import weights as tw  # noqa: E402
from crowdllama_tpu_torch.models import convert  # noqa: E402
from crowdllama_tpu_torch.models import transformer as T  # noqa: E402
from crowdllama_tpu_torch.models.config import get_config  # noqa: E402

NAME = "my-hf-model"  # not in either registry


def _hf_config(model: str, **extra):
    """The transformers config of a ``tiny-test*`` registry entry."""
    cfg = get_config(model)
    common = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  intermediate_size=cfg.intermediate_size,
                  num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads,
                  rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
                  max_position_embeddings=cfg.max_context_length,
                  tie_word_embeddings=cfg.tie_word_embeddings)
    common.update(extra)
    if cfg.family == "llama":
        return transformers.LlamaConfig(**common)
    if cfg.family == "mistral":
        return transformers.MistralConfig(sliding_window=cfg.sliding_window,
                                          **common)
    if cfg.family == "qwen2":
        return transformers.Qwen2Config(**common)
    if cfg.family == "qwen3":
        return transformers.Qwen3Config(head_dim=cfg.resolved_head_dim(),
                                        **common)
    if cfg.family == "gemma2":
        return transformers.Gemma2Config(
            head_dim=cfg.resolved_head_dim(),
            query_pre_attn_scalar=cfg.resolved_head_dim(),
            attn_logit_softcapping=cfg.attn_logit_softcap,
            final_logit_softcapping=cfg.final_logit_softcap,
            sliding_window=cfg.sliding_window, **common)
    if cfg.family == "mixtral":
        return transformers.MixtralConfig(
            num_local_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok, **common)
    raise ValueError(model)


_MODELS = {"llama": transformers.LlamaForCausalLM,
           "mistral": transformers.MistralForCausalLM,
           "qwen2": transformers.Qwen2ForCausalLM,
           "qwen3": transformers.Qwen3ForCausalLM,
           "gemma2": transformers.Gemma2ForCausalLM}


def _hf_model(model: str, seed: int = 0):
    cfg = get_config(model)
    torch.manual_seed(seed)
    hf = _MODELS[cfg.family](_hf_config(model)).eval()
    with torch.no_grad():
        # Norms and biases init to ones / zeros: perturb them so each is
        # load-bearing in the comparison.
        for name, p in hf.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    return hf


def _jax_flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_jax_flat(v, key))
        else:
            out[key] = torch.from_numpy(np.asarray(v, np.float32))
    return out


# ------------------------------------------------------------------ config

CONFIG_CASES = {
    "llama": ("tiny-test", {}),
    "llama-rope-llama3": ("tiny-test", dict(rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64})),
    "llama-rope-linear": ("tiny-test", dict(rope_scaling={
        "rope_type": "linear", "factor": 2.0})),
    "mistral": ("tiny-test-mistral", {}),
    "qwen2": ("tiny-test-qwen2", {}),
    "qwen3": ("tiny-test-qwen3", {}),
    "gemma2": ("tiny-test-gemma", {}),
    "mixtral": ("tiny-test-moe", {}),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_from_hf_dir_matches_jax(tmp_path, case):
    model, extra = CONFIG_CASES[case]
    hf = _hf_config(model, **extra)
    hf.architectures = [_MODELS.get(get_config(model).family,
                                    transformers.MixtralForCausalLM).__name__]
    hf.save_pretrained(str(tmp_path))
    want = dataclasses.asdict(jw.config_from_hf_dir(tmp_path))
    got = dataclasses.asdict(tw.config_from_hf_dir(tmp_path))
    assert got == want
    want = dataclasses.asdict(jw.resolve_model_config(NAME, str(tmp_path)))
    got = dataclasses.asdict(tw.resolve_model_config(NAME, str(tmp_path)))
    assert got == want and got["name"] == NAME
    # A registry name keeps the registry's entry.
    assert tw.resolve_model_config("tiny-test", str(tmp_path)) == \
        get_config("tiny-test")


def test_unsupported_rope_type_raises_in_both(tmp_path):
    hf = _hf_config("tiny-test", rope_scaling={"rope_type": "yarn",
                                               "factor": 4.0})
    hf.architectures = ["LlamaForCausalLM"]
    hf.save_pretrained(str(tmp_path))
    with pytest.raises(ValueError, match="yarn"):
        jw.config_from_hf_dir(tmp_path)
    with pytest.raises(ValueError, match="yarn"):
        tw.config_from_hf_dir(tmp_path)


# ----------------------------------------------------------------- weights

WEIGHT_CASES = [("tiny-test", "fp32", False), ("tiny-test", "bf16", False),
                ("tiny-test", "fp32", True), ("tiny-test", "bf16", True),
                ("tiny-test-mistral", "bf16", True),
                ("tiny-test-qwen2", "fp32", False),
                ("tiny-test-qwen3", "bf16", True),
                ("tiny-test-gemma", "fp32", True)]


@pytest.mark.parametrize("model,disk,sharded", WEIGHT_CASES,
                         ids=[f"{m}-{d}-{'sharded' if s else 'one'}"
                              for m, d, s in WEIGHT_CASES])
def test_loaded_params_equal_jax(tmp_path, model, disk, sharded):
    hf = _hf_model(model)
    if disk == "bf16":
        hf = hf.to(torch.bfloat16)
    hf.save_pretrained(str(tmp_path), safe_serialization=True,
                       max_shard_size="40KB" if sharded else "1GB")
    assert (tmp_path / "model.safetensors.index.json").exists() == sharded
    jcfg = jw.config_from_hf_dir(tmp_path)
    cfg = tw.config_from_hf_dir(tmp_path)
    want = _jax_flat(jw.load_safetensors_params(jcfg, tmp_path))
    got = tw.flatten_params(tw.load_safetensors_params(cfg, tmp_path))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(torch.from_numpy(got[k]), want[k]), k
    # The loader keeps bf16 on the host, and any dtype on request.
    loaded = tw.load_safetensors_params(cfg, tmp_path, dtype=torch.float32)
    assert loaded["layers"]["wq"].dtype == torch.float32
    # The inverse converter gives back the file's tensors.
    sd = hf.state_dict()
    back = convert.hf_state_dict(cfg, tw.load_safetensors_params(
        cfg, tmp_path, dtype=sd["model.norm.weight"].dtype))
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("model", ["tiny-test", "tiny-test-qwen2",
                                   "tiny-test-qwen3", "tiny-test-gemma",
                                   "tiny-test-mistral"])
def test_prefill_logits_match_hf_and_jax(tmp_path, model):
    hf = _hf_model(model)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tw.config_from_hf_dir(tmp_path)
    params = tw.load_safetensors_params(cfg, tmp_path, dtype=torch.float32)
    jcfg = jw.config_from_hf_dir(tmp_path)
    jparams = jw.load_safetensors_params(jcfg, tmp_path, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b, t = 2, 24
    tokens = rng.integers(0, cfg.vocab_size, (b, t))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.float().numpy()
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    got, _, _ = T.prefill([params], cfg, torch.from_numpy(tokens).long(),
                          torch.from_numpy(pos))
    want, _, _ = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                            jnp.asarray(pos))
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=8e-3, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=8e-3,
                               rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95


def test_mixtral_directory_raises_naming_item_7(tmp_path):
    """A ``transformers`` ``MixtralForCausalLM`` directory (ROADMAP Queue 1
    item 7, served since): its config is an MoE config, its tensors load
    bit for bit as JAX's ``params_from_hf`` loads them (router and expert
    banks ``w1`` / ``w3`` / ``w2`` into ``w_gate`` / ``w_up`` / ``w_down``),
    ``hf_state_dict`` gives back every tensor as written, and the logits
    are the HF model's and JAX's within 8e-3 (as the dense families')."""
    hf_cfg = _hf_config("tiny-test-moe")
    hf_cfg.architectures = ["MixtralForCausalLM"]
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tw.config_from_hf_dir(tmp_path)
    jcfg = jw.config_from_hf_dir(tmp_path)
    assert cfg.is_moe and (cfg.num_experts, cfg.num_experts_per_tok) == (
        jcfg.num_experts, jcfg.num_experts_per_tok) == (4, 2)
    params = tw.load_safetensors_params(cfg, tmp_path, dtype=torch.float32)
    jparams = jw.load_safetensors_params(jcfg, tmp_path, dtype=jnp.float32)
    flat = tw.flatten_params(params)
    jflat = jw._flatten_params(jparams)
    assert set(flat) == set(jflat)
    for name in flat:
        np.testing.assert_array_equal(flat[name], jflat[name])
    assert flat["layers/w_gate"].shape == (2, 4, 64, 128)
    written = tw.read_safetensors(tmp_path / "model.safetensors")
    back = convert.hf_state_dict(cfg, params)
    assert set(back) == set(written)
    for name, t in written.items():
        assert torch.equal(back[name], t.float()), name
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.float().numpy()
    got = T.prefill([params], cfg, torch.from_numpy(tokens).long(),
                    torch.from_numpy(pos))[0].numpy()
    want = np.asarray(JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos))[0], np.float32)
    np.testing.assert_allclose(got, ref, atol=8e-3, rtol=0)
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)


def test_quantize_stays_refused(tmp_path):
    """``quantize`` (ROADMAP Queue 1 item 10, served since):
    ``load_params_for`` returns the loaded weights quantized, with JAX's
    ``load_params_for``'s structure and scales, for both modes (values:
    ``tests/test_torch_quant.py``)."""
    from crowdllama_tpu.config import Configuration as JConfiguration
    from crowdllama_tpu_torch.config import Configuration
    from crowdllama_tpu_torch.ops.quant import QTensor, QTensor4

    hf = _hf_model("tiny-test")
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = tw.config_from_hf_dir(tmp_path)
    jcfg = jw.config_from_hf_dir(tmp_path)
    for mode, cls in (("int8", QTensor), ("int4", QTensor4)):
        got = tw.load_params_for(Configuration(
            model="tiny-test", model_path=str(tmp_path), quantize=mode), cfg)
        want = jw.load_params_for(JConfiguration(
            model="tiny-test", model_path=str(tmp_path), quantize=mode), jcfg)
        for k in ("wq", "wo", "w_gate", "w_down"):
            assert type(got["layers"][k]) is cls
            assert type(want["layers"][k]).__name__ == cls.__name__
            assert tuple(got["layers"][k].q.shape) == tuple(
                want["layers"][k].q.shape)
            np.testing.assert_array_equal(
                got["layers"][k].s.view(torch.uint16).numpy(),
                np.asarray(want["layers"][k].s).view(np.uint16))
        assert type(got["lm_head"]) is cls
        assert got["embed"].dtype == torch.bfloat16


# ----------------------------------------------------------------- engines

MAX_SEQ, PAGE = 256, 16
COMMON = dict(max_context_length=MAX_SEQ, kv_page_size=PAGE,
              step_token_budget=36, max_batch_slots=4, warmup=False)
TOKENS = 24
PROMPTS = {"plain": "hello world",
           "long": "a long prompt admitted in ragged chunks " * 2}
CHAT = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "Say something."}]


def _perm_hf_dir(path, vocab: int):
    """The port's permutation weights at tiny-test's widths and ``vocab``
    written as an HF Llama directory in two shards with an index."""
    from crowdllama_tpu_torch.testing.modelgen import permutation_params

    cfg = get_config("tiny-test", vocab_size=vocab,
                     max_context_length=MAX_SEQ)
    config = _hf_config("tiny-test", vocab_size=vocab).to_dict()
    config.update(architectures=["LlamaForCausalLM"], model_type="llama")
    tw.save_hf_checkpoint(
        convert.hf_state_dict(cfg, permutation_params(cfg)), config, path,
        shards=2)
    assert tw.is_hf_checkpoint(path)
    return str(path)


@pytest.fixture(scope="module")
def perm_hf_dir(tmp_path_factory):
    """Permutation weights over a 1,024-id vocab, with TinyLlama's kind of
    tokenizer (fewer ids: the rest decode to nothing) and chat template."""
    from test_torch_hf_tokenizer import save_family

    path = save_family("tinyllama", tmp_path_factory.mktemp("hf") / "dir")
    return _perm_hf_dir(path, 1024)


@pytest.fixture(scope="module")
def perm_draft_dir(tmp_path_factory):
    """Permutation weights at tiny-test's own widths (a registry
    architecture, as a draft dir must have), no tokenizer."""
    return _perm_hf_dir(tmp_path_factory.mktemp("draft") / "dir", 512)


class _Ids:
    """Tokenizer proxy recording the ids each stream decodes."""

    def __init__(self, tok, ids):
        self._tok, self._ids = tok, ids

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def stream_decoder(self):
        dec, ids = self._tok.stream_decoder(), self._ids

        class _Dec:
            def feed(self, t):
                ids.append(int(t))
                return dec.feed(t)

        return _Dec()


def _serve(engine, chat: bool = True) -> dict:
    async def go():
        await engine.start()
        out = {}
        try:
            for name, prompt in PROMPTS.items():
                ids: list[int] = []
                engine.tokenizer = _Ids(engine.tokenizer, ids)
                if chat:
                    prompt = engine._format_chat(
                        CHAT[:1] + [{"role": "user", "content": prompt}])
                text = ""
                async for chunk in engine.generate(prompt,
                                                   max_tokens=TOKENS):
                    text += chunk.text
                engine.tokenizer = engine.tokenizer._tok
                out[name] = (text, ids, engine.tokenizer.encode(prompt))
        finally:
            await engine.stop()
        return out

    return asyncio.run(go())


def _jax_engine(path, **kw):
    from crowdllama_tpu.config import Configuration, Intervals
    from crowdllama_tpu.engine.engine import JaxEngine

    return JaxEngine(Configuration(model=NAME, model_path=path,
                                   intervals=Intervals.default(),
                                   **COMMON, **kw))


def _torch_engine(path, **kw):
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    kw.setdefault("device", None if "devices" in kw else "cpu")
    return TorchEngine(dtype=torch.float32, model=NAME, model_path=path,
                       **COMMON, **kw)


@pytest.mark.parametrize("layout", ["paged", "contiguous", "tp2"])
def test_engine_streams_on_an_hf_directory_match_jax(perm_hf_dir, layout):
    """tp2: the loaded weights sharded from the host over two CPU ranks,
    against JAX's one-device paged engine."""
    kw = (dict(mesh_shape="2", devices=["cpu", "cpu"]) if layout == "tp2"
          else dict(kv_layout=layout))
    got = _serve(_torch_engine(perm_hf_dir, **kw))
    want = _serve(_jax_engine(perm_hf_dir, kv_layout=kw.get("kv_layout",
                                                            "paged")))
    assert got == want
    for text, ids, prompt_ids in got.values():
        assert len(ids) == TOKENS and text
        assert prompt_ids[0] == 1  # <s>


def test_draft_runner_on_an_hf_spec_draft_path_matches_jax(perm_draft_dir):
    kw = dict(spec_decode="draft", spec_draft=3, spec_draft_model="tiny-test",
              spec_draft_path=perm_draft_dir)
    got = _serve(_torch_engine(perm_draft_dir, **kw), chat=False)
    want = _serve(_jax_engine(perm_draft_dir, **kw), chat=False)
    assert got == want
    assert all(len(ids) == TOKENS for _, ids, _ in got.values())


def test_gateway_drafter_from_an_hf_directory_matches_jax(perm_draft_dir):
    from crowdllama_tpu.gateway.draft import GatewayDrafter as JaxDrafter
    from crowdllama_tpu_torch.gateway.draft import GatewayDrafter

    prompt = list(range(5, 40))
    tdraft = GatewayDrafter.from_checkpoint(perm_draft_dir, max_seq=MAX_SEQ,
                                            device="cpu",
                                            dtype=torch.float32)
    jdraft = JaxDrafter.from_checkpoint(perm_draft_dir, max_seq=MAX_SEQ)
    assert tdraft.cfg == dataclasses.replace(
        tw.config_from_hf_dir(perm_draft_dir), max_context_length=MAX_SEQ)
    ts, js = tdraft.session(prompt, 40), jdraft.session(prompt, 40)
    for k in (3, 4):
        assert ts.next_chunk(k) == js.next_chunk(k)


def test_cli_worker_flags_serve_an_hf_directory(perm_hf_dir):
    """``start --worker-mode --model <name> --model-path <dir>``: the
    CLI's engine (a ``MultiEngine``) renders the directory's template and
    streams what a ``TorchEngine`` on the same directory streams."""
    from crowdllama_tpu_torch.cli import main as tcli
    from crowdllama_tpu_torch.config import Configuration

    args = tcli.build_parser().parse_args([
        "start", "--worker-mode", "--device", "cpu", "--model", NAME,
        "--model-path", perm_hf_dir, "--kv-page-size", str(PAGE)])
    cfg = dataclasses.replace(Configuration.from_flags(args),
                              max_context_length=MAX_SEQ)
    assert (cfg.model, cfg.model_path) == (NAME, perm_hf_dir)

    async def go(engine):
        await engine.start()
        try:
            prompt = engine._format_chat(CHAT, model=NAME)
            text = ""
            async for chunk in engine.generate(prompt, model=NAME,
                                               max_tokens=8):
                text += chunk.text
            return prompt, text
        finally:
            await engine.stop()

    got = asyncio.run(go(tcli.make_engine(cfg)))
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    want = asyncio.run(go(TorchEngine(
        device="cpu", model=NAME, model_path=perm_hf_dir,
        max_context_length=MAX_SEQ, kv_page_size=PAGE)))
    assert got == want and got[0].startswith("<|system|>\n")
