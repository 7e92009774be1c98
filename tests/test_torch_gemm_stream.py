"""Kernel G's streaming schedule (``csrc/grouped_gemm.cu``
``grouped_stream_kernel``), its arithmetic pinned on the CPU.

- The register dequantisation, emulated in numpy bit for bit: int8 by the
  byte-permute / magic-exponent trick (``i8x4_to_bf16``), int4 two
  nibbles at a time into the mantissa of 128.0 (``i4x2_to_bf16``), then
  ``__hmul2`` by the bf16 scale (the exact product rounded once to bf16,
  to nearest even).  Exhaustively over all 256 int8 and 16 int4 values,
  in both nibbles of a byte (the JAX packing: column 2j the low nibble),
  times a spread of bf16 scales (subnormal, tiny, large, the largest,
  negative, zero): bit-equal to the port's ``dequant``, and to JAX's once
  a subnormal scale is read as a zero of its sign (XLA's CPU runtime
  treats subnormal inputs as zero; the port's ``dequant`` and the card's
  bf16 multiply do not).
- The fragments: ``ldmatrix.trans`` over the stored weight rows, emulated
  lane by lane for each format, then converted and scaled as the kernel
  does, hold ``dequant(W)[k, col]`` at the mma's A-operand places, with
  ``col`` the column the kernel's epilogue (``gs_col``) writes that
  accumulator row to.
- The plan (``ops/cuda/gemm.py launch_shape``) is a function of shapes
  alone: meta tensors, and the same shapes with other offsets, give the
  same launch; every llama-3-8b dense decode product and Mixtral decode
  shape of ``chip_smoke.py`` streams, with about two busy blocks an SM
  (or as many as its k tiles allow), within one wave of resident blocks
  or past one and a half; prefill shapes take the wgmma schedule.
- The split-K sum, emulated in torch in the kernel's fixed order (each
  split's fp32 partial over its k tiles, summed in split order, rounded
  to bf16 once), against ``grouped_gemm_plain`` and JAX's ``qragged_dot``
  / ``qeinsum`` at small widths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from crowdllama_tpu.ops import quant as JQ  # noqa: E402
from crowdllama_tpu_torch.ops import quant as Q  # noqa: E402
from crowdllama_tpu_torch.ops.cuda import gemm as G  # noqa: E402

# bf16 scales: subnormals, the smallest normal, tiny, ordinary, large, the
# largest finite, negatives of some, and zeros of both signs.
SCALE_BITS = np.array(
    [0x0001, 0x0040, 0x007F, 0x0080, 0x0B21, 0x2F80, 0x3A83, 0x3C01, 0x3F80,
     0x3FC1, 0x4300, 0x5A3B, 0x7E00, 0x7F00, 0x7F7F, 0x8001, 0x807F, 0x8080,
     0xBF80, 0xC1A7, 0xFF7F, 0x0000, 0x8000], np.uint16)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bits, rounded to nearest even (no NaN in these
    inputs)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _hmul2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``__hmul2`` on bf16 bits: the exact product (16 significant bits,
    exact in fp32 or past its range) rounded once to bf16."""
    with np.errstate(over="ignore"):
        exact = (_bf16_to_f32(a).astype(np.float64)
                 * _bf16_to_f32(b).astype(np.float64)).astype(np.float32)
    return _f32_to_bf16(exact)


def _i8x4_to_bf16(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's ``i8x4_to_bf16`` on uint32 words: (even, odd) pairs of
    bf16 bits, each pair [..., 2] (byte 0 / 1 low, byte 2 / 3 high)."""
    u = w.astype(np.uint32) ^ np.uint32(0x80808080)
    f = [((((u >> (8 * i)) & 0xFF) | np.uint32(0x4B000000)).view(np.float32)
          - np.float32(8388736.0)) for i in range(4)]
    hi = [x.view(np.uint32) >> 16 for x in f]
    even = np.stack([hi[0], hi[2]], -1).astype(np.uint16)
    odd = np.stack([hi[1], hi[3]], -1).astype(np.uint16)
    return even, odd


def _i4x2_to_bf16(w: np.ndarray, j: int) -> np.ndarray:
    """The kernel's ``i4x2_to_bf16<J>`` on uint32 words: nibble j of each
    16-bit half as a bf16 pair [..., 2] (low half first)."""
    v = ((w.astype(np.uint32) >> (4 * j)) & 0x000F000F) ^ 0x43084308
    pair = np.stack([v & 0xFFFF, v >> 16], -1).astype(np.uint16)
    # bf16x2 subtract of 136.0: exact, so fp32 then one rounding.
    return _f32_to_bf16(_bf16_to_f32(pair) - np.float32(136.0))


def _daz(bits: np.ndarray) -> np.ndarray:
    """bf16 bits with subnormals read as zeros of their sign."""
    return np.where(bits & 0x7F80 == 0, bits & 0x8000, bits).astype(np.uint16)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _jax_bf16(bits: np.ndarray):
    return jnp.asarray(bits.view(np.int16)).view(jnp.bfloat16)


def test_int8_register_dequant_is_bit_equal_to_dequant():
    """All 256 int8 values times every scale: the magic-exponent bytes are
    q exactly, and ``__hmul2`` by the scale equals both packages'
    ``dequant`` bit for bit."""
    q = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    # Four bytes a word as ldmatrix brings them: q at byte b of word i.
    words = np.frombuffer(np.tile(q, 4).reshape(4, 256).T.copy().tobytes(),
                          np.uint32)
    even, odd = _i8x4_to_bf16(words)
    exact = _f32_to_bf16(q.astype(np.float32))
    for got in (even[:, 0], odd[:, 0], even[:, 1], odd[:, 1]):
        np.testing.assert_array_equal(got, exact)
    emulated = _hmul2(exact[:, None], SCALE_BITS[None, :])
    s = torch.from_numpy(SCALE_BITS.view(np.int16)).view(torch.bfloat16)
    port = Q.dequant(Q.QTensor(q=torch.from_numpy(q)[:, None].repeat(
        1, len(SCALE_BITS)), s=s))
    jax = JQ.dequant(JQ.QTensor(q=jnp.asarray(np.repeat(
        q[:, None], len(SCALE_BITS), 1)), s=_jax_bf16(SCALE_BITS)))
    np.testing.assert_array_equal(_bits(port), emulated)
    np.testing.assert_array_equal(
        _bits(jax), _hmul2(exact[:, None], _daz(SCALE_BITS)[None, :]))


def test_int4_register_dequant_is_bit_equal_to_dequant():
    """All 16 int4 values in the low and in the high nibble (the JAX
    packing) times every scale: ``i4x2_to_bf16`` gives q exactly and
    ``__hmul2`` equals both packages' ``dequant`` bit for bit."""
    v = np.arange(-8, 8, dtype=np.int32)
    lo, hi = np.meshgrid(v, v, indexing="ij")
    lo, hi = lo.ravel(), hi.ravel()  # 256 (low, high) pairs
    packed = ((hi << 4) | (lo & 0xF)).astype(np.int8)  # one byte each
    # Two packed bytes a 16-bit half (columns 4c .. 4c + 3), the same
    # bytes in both halves (two k rows).
    half = packed.view(np.uint8).astype(np.uint32)
    half = half | (np.roll(half, 1) << 8)
    words = half | (half << 16)
    cols = [_i4x2_to_bf16(words, j)[:, 0] for j in range(4)]
    highs = [_i4x2_to_bf16(words, j)[:, 1] for j in range(4)]
    want = [lo, hi, np.roll(lo, 1), np.roll(hi, 1)]  # columns 4c .. 4c + 3
    for got, top, val in zip(cols, highs, want):
        np.testing.assert_array_equal(got, _f32_to_bf16(val.astype(np.float32)))
        np.testing.assert_array_equal(top, got)
    # The dequantised weight: one row of the 256 packed bytes (512
    # columns), one group, each scale.
    values = np.stack([lo, hi], -1).reshape(-1)  # column 2j low, 2j + 1 high
    for sb in SCALE_BITS:
        emulated = _hmul2(_f32_to_bf16(values.astype(np.float32)),
                          np.full(values.shape, sb, np.uint16))
        sbits = np.full((1, values.size), sb, np.uint16)
        port = Q.dequant(Q.QTensor4(
            q=torch.from_numpy(packed[None]),
            s=torch.from_numpy(sbits.view(np.int16)).view(torch.bfloat16)))
        jax = JQ.dequant(JQ.QTensor4(q=jnp.asarray(packed[None]),
                                     s=_jax_bf16(sbits)))
        np.testing.assert_array_equal(_bits(port)[0], emulated)
        np.testing.assert_array_equal(
            _bits(jax)[0], _hmul2(_f32_to_bf16(values.astype(np.float32)),
                                  np.full(values.shape, _daz(sb), np.uint16)))


# ------------------------------------------------------------ fragments

def _ldsm_x4_trans(tile: np.ndarray, rows: list[int], col_byte: int
                   ) -> np.ndarray:
    """``ldmatrix.sync.aligned.m8n8.x4.trans.b16`` of a stored byte tile:
    lane l gives the row address (rows[l], col_byte); returns regs [32, 4]
    uint32: matrix i's element (row 2 (t % 4) + h, b16 column t / 4) in
    half h of thread t's register i."""
    regs = np.zeros((32, 4), np.uint32)
    for t in range(32):
        for i in range(4):
            for h in range(2):
                r = rows[8 * i + 2 * (t % 4) + h]
                b = tile[r, col_byte + 2 * (t // 4): col_byte + 2 * (t // 4) + 2]
                regs[t, i] |= np.uint32(int(b[0]) | int(b[1]) << 8) << (16 * h)
    return regs


def _gs_col(mode: int, warp: int, t: int, L: int) -> int:
    """``gs_col<MODE>`` of the kernel."""
    if mode == 0:
        return warp * 16 + L
    if mode == 1:
        return warp * 32 + t * 16 + (2 * L if L < 8 else 2 * (L - 8) + 1)
    return warp * 32 + 4 * (L % 8) + 2 * t + (L >= 8)


def _a_places(lane: int, reg: int) -> tuple[int, int]:
    """The m16n8k16 A operand's (row, first k) of a register (two k)."""
    gq, tq = lane // 4, lane % 4
    return gq + 8 * (reg % 2), 2 * tq + 8 * (reg // 2)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_fragments_hold_the_dequantised_weight_at_their_columns(fmt):
    """Every warp's A fragments of a stored tile of 64 rows and a block's
    columns (64 for bf16, 128 for int8 and int4), loaded and converted as
    the kernel does, equal ``dequant(W)`` at (k, the column its
    accumulator row is written to)."""
    r = np.random.default_rng(0)
    cols = G.STREAM_COLS[fmt]
    w = (r.standard_normal((64, cols)) * 0.05).astype(np.float32)
    wt = torch.from_numpy(w)
    qw = {"bf16": lambda t: t.to(torch.bfloat16),
          "int8": Q.quantize_weight,
          "int4": lambda t: Q.quantize_weight_int4(t, group=16)}[fmt](wt)
    want = _bits(Q.dequant(qw).to(torch.bfloat16))  # [64, 128]
    stored = (qw.q if fmt != "bf16" else qw).contiguous()
    tile = stored.view(torch.uint8).numpy() if fmt != "bf16" else \
        stored.view(torch.int16).numpy().view(np.uint8)
    s = None if fmt == "bf16" else _bits(qw.s)
    for warp in range(4):
        for kh in range(2):
            for t in range(1 if fmt == "bf16" else 2):
                for ks in range(2):
                    k0 = kh * 32 + ks * 16
                    frag = np.zeros((32, 4, 2), np.uint16)
                    if fmt == "bf16":
                        # matrix i: rows k0 + (i >> 1) * 8, columns
                        # (i & 1) * 8 of the tile's 16 columns.
                        regs = np.zeros((32, 4), np.uint32)
                        for i in range(4):
                            rows = [k0 + (i >> 1) * 8 + j % 8
                                    for j in range(32)]
                            m = _ldsm_x4_trans(
                                tile, rows, (warp * 16 + (i & 1) * 8) * 2)
                            regs[:, i] = m[:, 0]
                        frag[..., 0] = regs & 0xFFFF
                        frag[..., 1] = regs >> 16
                    elif fmt == "int8":
                        regs = _ldsm_x4_trans(
                            tile, [kh * 32 + j for j in range(32)],
                            warp * 32 + t * 16)
                        col = [warp * 32 + t * 16 + 2 * (lane // 4)
                               for lane in range(32)]
                        se = s[col]
                        so = s[[c + 1 for c in col]]
                        e0, o0 = _i8x4_to_bf16(regs[:, 2 * ks])
                        e1, o1 = _i8x4_to_bf16(regs[:, 2 * ks + 1])
                        frag[:, 0] = _hmul2(e0, se[:, None])
                        frag[:, 1] = _hmul2(o0, so[:, None])
                        frag[:, 2] = _hmul2(e1, se[:, None])
                        frag[:, 3] = _hmul2(o1, so[:, None])
                    else:
                        regs = _ldsm_x4_trans(
                            tile, [kh * 32 + j for j in range(32)], warp * 16)
                        g = (k0) // 16  # one group a k-step at group 16
                        base = [warp * 32 + 4 * (lane // 4)
                                for lane in range(32)]
                        p = [s[g][[b + j for b in base]] for j in range(4)]
                        rl, rh = regs[:, 2 * ks], regs[:, 2 * ks + 1]
                        frag[:, 0] = _hmul2(_i4x2_to_bf16(rl, 2 * t),
                                            p[2 * t][:, None])
                        frag[:, 1] = _hmul2(_i4x2_to_bf16(rl, 2 * t + 1),
                                            p[2 * t + 1][:, None])
                        frag[:, 2] = _hmul2(_i4x2_to_bf16(rh, 2 * t),
                                            p[2 * t][:, None])
                        frag[:, 3] = _hmul2(_i4x2_to_bf16(rh, 2 * t + 1),
                                            p[2 * t + 1][:, None])
                    for lane in range(32):
                        for reg in range(4):
                            L, kk = _a_places(lane, reg)
                            col = _gs_col({"bf16": 0, "int8": 1,
                                           "int4": 2}[fmt], warp, t, L)
                            np.testing.assert_array_equal(
                                frag[lane, reg],
                                want[k0 + kk: k0 + kk + 2, col],
                                err_msg=f"{fmt} warp {warp} kh {kh} t {t} "
                                        f"ks {ks} lane {lane} reg {reg}")


def test_columns_of_a_block_are_each_written_once():
    """``gs_col`` maps the 4 warps x their 16-column tiles (one for bf16,
    two for int8 and int4) x 16 accumulator rows onto the block's columns
    one to one, in every format."""
    for mode, fmt in enumerate(("bf16", "int8", "int4")):
        tiles = 1 if fmt == "bf16" else 2
        cols = sorted(_gs_col(mode, w, t, L) for w in range(4)
                      for t in range(tiles) for L in range(16))
        assert cols == list(range(G.STREAM_COLS[fmt]))


# ------------------------------------------------------------------ plan

def _decode_shapes() -> list[tuple]:
    """(m, k, n, experts) of chip_smoke's Mixtral decode and llama-3-8b
    dense decode products."""
    out = []
    for slots in chip_smoke.GEMM_DECODE_SLOTS:
        for k, n in ((chip_smoke.MIX_D, chip_smoke.MIX_F),
                     (chip_smoke.MIX_F, chip_smoke.MIX_D)):
            out.append((2 * slots, k, n, chip_smoke.MIX_E))
    out += [(m, k, n, 1) for m, k, n in chip_smoke.GEMM_DENSE if m <= 8]
    return out


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("shape", _decode_shapes())
def test_decode_products_stream_filling_a_wave(fmt, shape):
    """Every decode product streams; its busy blocks give the 132 SMs about
    two blocks each (at least 1.5; or every split already walks the fewest
    k tiles); busy (column tile, expert) pairs that fit in one wave of
    resident blocks stay within it, and a launch past one wave reaches one
    and a half (no short tail); each split holds a k tile, and the splits
    cover K."""
    m, k, n, e = shape
    p = G.launch_shape(m, k, n, e, fmt, k // Q.GROUP)
    ktiles = k // G.K_TILE
    assert p["schedule"] == "stream" and p["threads"] == 128
    assert p["grid"] == (-(-n // G.STREAM_COLS[fmt]), e, p["split"])
    assert p["wave"] == G.SMS * G.STREAM_BLOCKS_PER_SM[fmt]
    assert p["busy_blocks"] >= 1.5 * G.SMS or (
        p["ktiles_per_split"] == G.MIN_SPLIT_KTILES)
    pairs = p["busy_blocks"] // p["split"]
    if pairs <= p["wave"]:
        assert p["busy_blocks"] <= p["wave"]
    assert p["busy_blocks"] <= p["wave"] or (
        2 * p["busy_blocks"] >= 3 * p["wave"])
    per = -(-ktiles // p["split"])  # the kernel's own k tiles a split
    assert per == p["ktiles_per_split"]
    assert (p["split"] - 1) * per < ktiles <= p["split"] * per


@pytest.mark.parametrize("shape", [
    (2 * chip_smoke.GEMM_PREFILL_TOKENS, 4096, 14336, 8),
    (512, 4096, 4096, 1), (512, 14336, 4096, 1), (40, 4096, 4096, 1)])
def test_many_rows_an_expert_take_the_wgmma_schedule(shape):
    m, k, n, e = shape
    for fmt in ("bf16", "int8", "int4"):
        p = G.launch_shape(m, k, n, e, fmt, k // Q.GROUP)
        assert p["schedule"] == "wgmma"
        assert p["grid"] == (-(-n // G.COL_TILE), e, G.msplit_for(m, e))
        assert p["split"] == max(1, min(-(-(-(-m // 128)) // e), 32))


def test_int4_groups_off_the_k_step_take_the_wgmma_schedule():
    """An int4 group that is not a multiple of 16 rows (a k-step would
    span two scales) never streams."""
    assert G.launch_shape(8, 192, 128, 1, "int4", 8)["schedule"] == "wgmma"
    assert G.launch_shape(8, 192, 128, 1, "int4", 3)["schedule"] == "stream"
    assert G.launch_shape(8, 192, 128, 1, "int8", 4)["schedule"] == "stream"


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
def test_plan_reads_shapes_alone(fmt):
    """Meta tensors (no values) and two different routings of the same
    shapes give one launch."""
    e, k, n, m = 8, 4096, 14336, 16
    meta = dict(device="meta")
    xs = torch.empty((m, k), dtype=torch.bfloat16, **meta)
    if fmt == "bf16":
        w = torch.empty((e, k, n), dtype=torch.bfloat16, **meta)
    elif fmt == "int8":
        w = Q.QTensor(q=torch.empty((e, k, n), dtype=torch.int8, **meta),
                      s=torch.empty((e, n), dtype=torch.bfloat16, **meta))
    else:
        w = Q.QTensor4(q=torch.empty((e, k, n // 2), dtype=torch.int8, **meta),
                       s=torch.empty((e, k // 64, n), dtype=torch.bfloat16,
                                     **meta))
    a = torch.tensor([0, 16, 16, 16, 16, 16, 16, 16, 16], dtype=torch.int32)
    b = torch.tensor([0, 1, 3, 5, 7, 9, 11, 13, 16], dtype=torch.int32)
    plans = [G.gemm_launch_shape(xs, w, off) for off in
             (a, b, torch.empty(9, dtype=torch.int32, **meta))]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0] == G.launch_shape(m, k, n, e, fmt, k // 64)


# --------------------------------------------------------------- split-K

def _split_k_emulation(xs: torch.Tensor, w, offsets: torch.Tensor,
                       plan: dict) -> torch.Tensor:
    """The streaming kernel's sums in its order: per expert and split,
    the fp32 product of the rows with the dequantised (bf16) weight over
    the split's k tiles; the partials added in split order; one bf16
    rounding."""
    wd = Q.dequant(w).float()
    if wd.dim() == 2:
        wd = wd[None]
    per = plan["ktiles_per_split"] * G.K_TILE
    out = torch.zeros((xs.shape[0], wd.shape[-1]), dtype=torch.bfloat16)
    for e in range(wd.shape[0]):
        lo, hi = int(offsets[e]), int(offsets[e + 1])
        if lo == hi:
            continue
        x = xs[lo:hi].float()
        parts = [x[:, z * per:(z + 1) * per] @ wd[e, z * per:(z + 1) * per]
                 for z in range(plan["split"])]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        out[lo:hi] = total.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("sizes,k,n", [
    ([3, 0, 5, 2], 1024, 192),    # split K, a last column tile of 64
    ([1], 2048, 128),             # the dense product, 8 splits
    ([40, 0, 0, 1], 512, 256),    # more rows than a pass on one expert
])
def test_split_k_sum_matches_plain_and_jax(fmt, sizes, k, n):
    """The emulated split sums against ``grouped_gemm_plain`` (the port's
    plain version) and JAX's ``qragged_dot`` (and ``qeinsum`` for the
    dense product), bf16 activations: within one bf16 rounding of the
    output, 1e-2 of its scale (the kernel's check allows 0.0156)."""
    r = np.random.default_rng(7)
    e = len(sizes)
    m = sum(sizes)
    wf = (r.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    xf = r.standard_normal((m, k)).astype(np.float32)
    quant = {"bf16": (lambda a: torch.from_numpy(a).to(torch.bfloat16),
                      lambda a: jnp.asarray(a, jnp.bfloat16)),
             "int8": (lambda a: Q.quantize_weight(torch.from_numpy(a)),
                      lambda a: JQ.quantize_weight(jnp.asarray(a))),
             "int4": (lambda a: Q.quantize_weight_int4(torch.from_numpy(a)),
                      lambda a: JQ.quantize_weight_int4(jnp.asarray(a)))}
    tw, jw = quant[fmt][0](wf), quant[fmt][1](wf)
    xs = torch.from_numpy(xf).to(torch.bfloat16)
    offsets = torch.tensor([0, *np.cumsum(sizes)], dtype=torch.int32)
    plan = G.launch_shape(m, k, n, e, fmt, k // Q.GROUP)
    assert plan["schedule"] == "stream" and plan["split"] > 1
    got = _split_k_emulation(xs, tw, offsets, plan)
    scale = None
    for want in (
            G.grouped_gemm_plain(xs, tw, offsets).float().numpy(),
            np.asarray(JQ.qragged_dot(jnp.asarray(xf, jnp.bfloat16), jw,
                                      jnp.asarray(sizes, jnp.int32)),
                       np.float32)):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-2 * scale, rtol=0)
    if e == 1:
        want = np.asarray(JQ.qeinsum("mk,kn->mn",
                                     jnp.asarray(xf, jnp.bfloat16),
                                     JQ.QTensor(jw.q[0], jw.s[0])
                                     if fmt == "int8" else
                                     JQ.QTensor4(jw.q[0], jw.s[0])
                                     if fmt == "int4" else jw[0]),
                          np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-2 * scale, rtol=0)
