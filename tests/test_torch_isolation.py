"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, uses no library attention, never drops to the CPU on its own, and
its kernel wrappers run the plain version only for CPU tensors (and refuse
an int8 pool whose scales do not pair with it, on every device)."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from crowdllama_tpu_torch.ops import cuda as kernels  # noqa: E402
from crowdllama_tpu_torch.ops.attention import (  # noqa: E402
    decode_attention_ref,
    prefill_attention_ref,
)
from crowdllama_tpu_torch.ops.cuda.flash import (  # noqa: E402
    flash_decode_attention,
    flash_prefill_attention,
)
from crowdllama_tpu_torch.ops.cuda.paged import (  # noqa: E402
    flash_paged_decode_attention,
    paged_decode_attention_plain,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "crowdllama_tpu_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "crowdllama_tpu", "google", "aiohttp", "cryptography"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_port_calls_no_library_attention():
    for path in PORT:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            name = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name) else "")
            assert name != "scaled_dot_product_attention", path


def test_engine_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    from crowdllama_tpu_torch.engine.engine import TorchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine()
    assert TorchEngine(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_runners_without_cuda_raise_instead_of_running_on_cpu(monkeypatch,
                                                               layout):
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.paged import PagedModelRunner
    from crowdllama_tpu_torch.engine.runner import ModelRunner
    from crowdllama_tpu_torch.models.config import get_config

    cls = PagedModelRunner if layout == "paged" else ModelRunner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(get_config("tiny-test"))
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(kv_layout=layout)


def _attn_inputs(device="cpu"):
    r = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to(device)

    b, hkv, page = 2, 2, 16
    return dict(
        q=t(b, 32, 4, 16), k=t(b, hkv, 32, 16), v=t(b, hkv, 32, 16),
        pos=torch.arange(32, dtype=torch.int32).repeat(b, 1).to(device),
        dq=t(b, 4, 16), pk=t(6, hkv, page, 16), pv=t(6, hkv, page, 16),
        kc=t(b, hkv, 32, 16), vc=t(b, hkv, 32, 16),
        table=torch.tensor([[0, 1], [2, 5]], dtype=torch.int32).to(device),
        lens=torch.tensor([20, 3], dtype=torch.int32).to(device),
        rq=t(b + 8, 4, 16), ck=t(1, hkv, 8, 16), cv=t(1, hkv, 8, 16),
        ql=torch.tensor([1, 0, 8], dtype=torch.int32).to(device),
        kl=torch.tensor([20, 1, 12], dtype=torch.int32).to(device))


def _counts():
    return (flash_prefill_attention.launches,
            flash_decode_attention.launches,
            flash_paged_decode_attention.launches,
            flash_paged_decode_attention.launches_int8,
            ragged_paged_attention.launches,
            ragged_paged_attention.launches_int8)


def test_cpu_tensors_run_the_plain_version_without_launching():
    x = _attn_inputs()
    before = _counts()
    got = flash_prefill_attention(x["q"], x["k"], x["v"], x["pos"], 0.25)
    torch.testing.assert_close(
        got, prefill_attention_ref(x["q"], x["k"], x["v"], x["pos"], 0.25),
        rtol=0, atol=0)
    got = flash_decode_attention(x["dq"], x["kc"], x["vc"], x["lens"], 0.25)
    torch.testing.assert_close(
        got, decode_attention_ref(x["dq"], x["kc"], x["vc"], x["lens"], 0.25),
        rtol=0, atol=0)
    got = flash_paged_decode_attention(x["dq"], x["pk"], x["pv"], x["table"],
                                       x["lens"], 0.25)
    torch.testing.assert_close(
        got, paged_decode_attention_plain(x["dq"], x["pk"], x["pv"],
                                          x["table"], x["lens"], 0.25),
        rtol=0, atol=0)
    args = (x["rq"], x["ck"], x["cv"], x["pk"], x["pv"], x["table"], x["ql"],
            x["kl"], 1, 0.25)
    torch.testing.assert_close(ragged_paged_attention(*args),
                               ragged_paged_attention_ref(*args),
                               rtol=0, atol=0)
    assert _counts() == before


def test_non_cpu_tensors_the_kernels_refuse_raise_without_launching():
    """A tensor that is not on the CPU is launched or refused, never run
    through the plain version (meta tensors stand in for unsupported
    devices and shapes here)."""
    x = _attn_inputs("meta")
    before = _counts()
    with pytest.raises(ValueError):
        flash_prefill_attention(x["q"], x["k"], x["v"], x["pos"], 0.25)
    with pytest.raises(ValueError):
        flash_decode_attention(x["dq"], x["kc"], x["vc"], x["lens"], 0.25)
    with pytest.raises(ValueError):
        flash_paged_decode_attention(x["dq"], x["pk"], x["pv"], x["table"],
                                     x["lens"], 0.25)
    with pytest.raises(ValueError):
        ragged_paged_attention(x["rq"], x["ck"], x["cv"], x["pk"], x["pv"],
                               x["table"], x["ql"], x["kl"], 1, 0.25)
    assert _counts() == before


def _int8_pool(x):
    """The fp32 pools of ``x`` as int8 with bf16 scales [P, Hkv, page]."""
    from crowdllama_tpu_torch.ops.quant import quantize_kv

    (pk8, ksc), (pv8, vsc) = quantize_kv(x["pk"]), quantize_kv(x["pv"])
    return pk8, pv8, ksc, vsc


@pytest.mark.parametrize("case", [
    "int8_pool_without_scales", "scales_with_float_pool", "one_scale_only",
    "scale_shape", "scale_dtype"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_int8_pool_and_scales_must_pair(case, device):
    """The paged wrappers refuse an int8 pool without scales, scales with a
    float pool and scales of the wrong shape or dtype, on every device,
    before any plain version runs or kernel launches."""
    x = _attn_inputs()
    pk8, pv8, ksc, vsc = _int8_pool(x)
    pools, scales = (pk8, pv8), dict(k_scale=ksc, v_scale=vsc)
    if case == "int8_pool_without_scales":
        scales = {}
    elif case == "scales_with_float_pool":
        pools = (x["pk"], x["pv"])
    elif case == "one_scale_only":
        scales = dict(k_scale=ksc)
    elif case == "scale_shape":
        scales["v_scale"] = vsc[:, :, :-1]
    else:
        scales["k_scale"] = ksc.float()
    move = lambda t: t.to(device)  # noqa: E731
    pools = tuple(map(move, pools))
    scales = {k: move(v) for k, v in scales.items()}
    x = {k: move(v) for k, v in x.items()}
    before = _counts()
    with pytest.raises(ValueError, match="scale|int8"):
        flash_paged_decode_attention(x["dq"], *pools, x["table"], x["lens"],
                                     0.25, **scales)
    with pytest.raises(ValueError, match="scale|int8"):
        ragged_paged_attention(x["rq"], x["ck"], x["cv"], *pools, x["table"],
                               x["ql"], x["kl"], 1, 0.25, **scales)
    assert _counts() == before


def test_int8_cpu_tensors_run_the_plain_version_without_launching():
    from crowdllama_tpu_torch.ops.attention import decode_attention_q

    x = _attn_inputs()
    pk8, pv8, ksc, vsc = _int8_pool(x)
    sc = dict(k_scale=ksc, v_scale=vsc)
    before = _counts()
    got = flash_paged_decode_attention(x["dq"], pk8, pv8, x["table"],
                                       x["lens"], 0.25, **sc)
    torch.testing.assert_close(
        got, paged_decode_attention_plain(x["dq"], pk8, pv8, x["table"],
                                          x["lens"], 0.25, **sc),
        rtol=0, atol=0)
    # Slot 1's three keys sit at the start of page 2.
    want = decode_attention_q(x["dq"][1:], pk8[2][None], ksc[2][None],
                              pv8[2][None], vsc[2][None], x["lens"][1:],
                              0.25)
    torch.testing.assert_close(got[1:], want, rtol=0, atol=1e-6)
    args = (x["rq"], x["ck"], x["cv"], pk8, pv8, x["table"], x["ql"],
            x["kl"], 1, 0.25)
    torch.testing.assert_close(ragged_paged_attention(*args, **sc),
                               ragged_paged_attention_ref(*args, **sc),
                               rtol=0, atol=0)
    assert _counts() == before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc means a raised build error, not a silent plain path; the
    library name carries a content hash of the sources."""
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "CUDA_ROOTS", ())
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(kernels.KernelBuildError, match="nvcc"):
        kernels.build_all()
    name = kernels._lib_path("flash_prefill").name
    assert name.startswith("flash_prefill-") and name.endswith(".so")
