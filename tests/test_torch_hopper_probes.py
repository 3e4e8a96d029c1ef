"""The Hopper forms of the stream, int8-dL/dx, ResMLP body, chain, bigN and
int8 chain probes, on the CPU: the layouts their kernels read
(``r2l_train.stage_qdx_weights``' image of q^T, the S = 4 form's
half-stages of K2's image, the probes' staged images and epilogue and scale
tables), the int8-dL/dx kernel's tiles, the bf16 bodies' k order held to
``chip_smoke.py``'s limits, the int8 wall's one accumulator, that none of
their translation units reaches the pre-Hopper engine (which only the
mma.sync instrument keeps), and how a parent comparison calls and holds a
parent's build of the probes. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from r2l_tpu_torch.exp import _harness
from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
from r2l_tpu_torch.exp import probe_int8 as PI
from r2l_tpu_torch.exp import probe_mxu as PM
from r2l_tpu_torch.exp import probe_pipe_lib as PL
from r2l_tpu_torch.exp import probe_wall as PW
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
from r2l_tpu_torch.kernels.staging import STAGE_K
from r2l_tpu_torch.models import R2LConfig


def _read_b(stage: np.ndarray, rows: int, k: int) -> np.ndarray:
    """A stage as wgmma reads B (K-major core matrices, no swizzle): row n
    (the product's output), byte b of K at ((n // 8) * (k // 16) + b // 16)
    * 128 + (n % 8) * 16 + b % 16 (leading offset 128 along K, stride
    8 k along N) -> [rows, k] int8."""
    n, b = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    off = ((n // 8) * (k // 16) + b // 16) * 128 + (n % 8) * 16 + b % 16
    return stage.view(np.int8)[off]


@pytest.mark.parametrize("W", [64, 256])
def test_qdx_image_gives_uq_qT_exactly(W):
    """Each layer's stages of ``stage_qdx_weights``, read as the kernel's
    B in its k order (128 output channels a stage, 64 at W64), give
    u_q @ q^T in int32 exactly: the dx product ``(u_q @ q_l^T)`` of the
    plain version."""
    rng = np.random.default_rng(W)
    L = 3
    q = rng.integers(-127, 128, (L, W, W)).astype(np.int8)   # [out, in]
    uq = rng.integers(-127, 128, (64, W)).astype(np.int64)    # [rays, out]
    img = T.stage_qdx_weights(torch.from_numpy(q)).numpy()
    k = T.qdx_stage_k(W)
    assert img.size == L * W * W
    for l in range(L):
        acc = np.zeros((64, W), np.int64)
        for st in range(W // k):
            off = (l * (W // k) + st) * W * k
            b = _read_b(img[off:off + W * k], W, k).astype(np.int64)
            acc += uq[:, st * k:(st + 1) * k] @ b.T
        want = uq @ q[l].astype(np.int64)
        np.testing.assert_array_equal(acc, want)
        assert np.abs(acc).max() < 2 ** 22   # the kernel's i2f adds: exact
    back = T.unstage_qdx_weights(torch.from_numpy(img), (L, W, W))
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("tile", PQ.KERNEL_TILES)
def test_qdx_tiles_cover_every_ray_once(tile):
    """The kernel's tile -> (warpgroups, blocks, cluster) map: every ray of
    n in exactly one tile and one warpgroup, each tile's warpgroups
    consecutive and its blocks inside one cluster of max(2, tile / 128)
    blocks; a tile of 64 rays is one warpgroup's own, 128 a block's, 256 a
    2-block cluster's, 512 a 4-block cluster's."""
    n = 8 * 512 + (tile if tile < 512 else 0)   # also an odd block count
    tiles = PQ.tile_members(n, tile)
    assert len(tiles) == n // tile
    seen = np.zeros(n, np.int64)
    wgs = []
    for tm in tiles:
        lo, hi = tm["rays"]
        assert hi - lo == tile
        seen[lo:hi] += 1
        wgs += tm["warpgroups"]
        first = tm["warpgroups"][0]
        assert tm["warpgroups"] == list(range(first, first + tile // 64))
        assert len(tm["cluster"]) == max(2, tile // 128)
        assert set(tm["blocks"]) <= set(tm["cluster"])
        assert len(tm["blocks"]) == max(1, tile // 128)
    assert (seen == 1).all()
    assert sorted(wgs) == list(range(n // 64))
    with pytest.raises(ValueError):
        PQ.tile_members(n, 192)


def test_streams4_half_stages_read_back_the_weights():
    """The S = 4 form's ring, in its producer's order: each 16 KB slot is
    half of one of K2's image stages, and read as the kernel's B it holds
    the weights of its (layer, input channels, half of the outputs): the
    head's in ``int8_head_columns`` order, each body layer's; each (layer,
    stage, half) once; half 0 of the head over the slices from the first,
    half 1 from the last."""
    torch.manual_seed(0)
    cfg = R2LConfig(input_dim=48 * 21, netdepth=6, netwidth=256,
                    compute_dtype=torch.bfloat16)
    W, nbl, dp, L = 256, cfg.num_blocks * cfg.n_learnable, 48, 10
    in_pad = F._padded_in(dp * (2 * L + 1))
    rnd = lambda *s: torch.randint(-127, 128, s, dtype=torch.int8)   # noqa
    f32 = lambda *s: torch.rand(s)   # noqa
    fp = F.FusedParamsInt8PE(
        rnd(W, in_pad), f32(W), f32(W), f32(dp * (2 * L + 1)),
        rnd(nbl, W, W), f32(nbl, W), f32(nbl, W), f32(nbl, W),
        rnd(3, W), f32(3), f32(3), f32(W))
    img = F.stage_int8_chain(fp, cfg, dp, L).numpy()
    cols = F.int8_head_columns(cfg, dp, L).numpy()
    head = np.where(cols >= 0, fp.head_q.numpy()[:, np.maximum(cols, 0)], 0)
    order = PL.streams4_fill_order(cfg, dp, L)
    plan = F.int8_chain_stage_plan(cfg, dp, L)
    k = plan["stage_k"]
    assert len(order) == 2 * plan["stages"]
    assert len(set(order)) == len(order)
    for off, layer, c0, o0 in order:
        got = _read_b(img[off:off + W // 2 * k], W // 2, k)
        w = head if layer < 0 else fp.body_q[layer].numpy()
        np.testing.assert_array_equal(got, w[o0:o0 + W // 2, c0:c0 + k])
    heads = [(c0, o0) for _, layer, c0, o0 in order if layer < 0]
    half = len(heads) // 2
    assert [c for c, _ in heads[:half]] == sorted(c for c, _ in heads[:half])
    assert heads[half][0] == 2 * W * ((plan["kpad"] - 1) // (2 * W))


def _translation_unit(name: str) -> str:
    """The source of csrc/<name>.cu with every header it includes from
    csrc, transitively, comments removed."""
    seen, out, todo = set(), [], [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        text = (_build.CSRC / f).read_text()
        todo += re.findall(r'#include "([^"]+)"', text)
        out.append(re.sub(r"//[^\n]*", "", text))
    return "\n".join(out)


@pytest.mark.parametrize("lib", ["r2l_int8_hopper", "r2l_bwd_qdx",
                                 "probe_resmlp", "probe_chain", "probe_bign",
                                 "probe_int8_chain"])
def test_hopper_probes_reach_no_pre_hopper_engine(lib):
    """K2's translation unit (which holds the stream probe's forms), the
    int8-dL/dx probe's, the ResMLP body probe's, the chain probe's, bigN's
    and the int8 chain's include no pre-Hopper engine and issue no
    mma.sync: wgmma only."""
    tu = _translation_unit(lib)
    assert "r2l_engines.cuh" not in tu and "probe_common.cuh" not in tu
    assert "EngineS8" not in tu and "EngineBF16" not in tu
    assert "mma.sync" not in tu
    assert "wgmma.mma_async" in tu


def test_only_the_mma_sync_instrument_keeps_the_pre_hopper_engine():
    """``probe_common.cuh`` is gone; of every library, only the mma.sync
    rounding instrument's translation unit reaches ``r2l_engines.cuh``,
    which holds the bf16 engine alone (no int8 or f32 engine, no team
    parameter)."""
    assert not (_build.CSRC / "probe_common.cuh").exists()
    reach = {name for name in _build.KERNELS
             if "r2l_engines.cuh" in _translation_unit(name)}
    assert reach == {"probe_mma_sync"}
    engines = re.sub(r"//[^\n]*", "",
                     (_build.CSRC / "r2l_engines.cuh").read_text())
    assert "EngineBF16" in engines and "mma.sync" in engines
    for gone in ("EngineS8", "EngineF32", "TileMap", "Team", "mma_s8"):
        assert gone not in engines, gone


def _stages_read_back(img: np.ndarray, w: np.ndarray, k: int) -> None:
    """Each layer's stages of ``img`` (``k`` input channels for all 256
    outputs, in order), read as the kernel's B, are that layer's weights
    [out, in]; the image holds them whole, nothing else."""
    L, N, K = w.shape
    es = w.dtype.itemsize
    sb = N * k * es
    assert img.size == L * (K // k) * sb
    for l in range(L):
        for st in range(K // k):
            off = (l * (K // k) + st) * sb
            got = _read_b(img[off:off + sb], N, k * es).view(w.dtype)
            np.testing.assert_array_equal(got, w[l, :, st * k:(st + 1) * k])


@pytest.mark.parametrize("body", sorted(PI.BODIES))
def test_resmlp_image_reads_back_its_weights(body):
    """``stage_resmlp``'s image: each layer's stages of 128 int8 (64 bf16)
    input channels, read as the kernel's B, hold the weights; ``unstage``
    gives them back whole."""
    name = {"int8": "int8_resmlp", "int8_fold": "int8_resmlp_fold",
            "bf16": "bf16_resmlp"}[body]
    w, m, b = PI.variant_weights(name, "cpu", n_blocks=2)
    img = PI.stage_resmlp(w, m, b, body)
    wn = (w.view(torch.int16) if body == "bf16" else w).numpy()
    _stages_read_back(img.data.numpy(), wn, STAGE_K[w.dtype])
    assert torch.equal(PI.unstage_resmlp(img).view(torch.uint8),
                       w.view(torch.uint8))
    assert (img.table is None) == (body == "bf16")


def test_chain_image_reads_back_its_weights():
    """``stage_chain``'s image: each layer's four stages of 64 bf16 input
    channels, read as the kernel's B, hold the weights; ``unstage`` gives
    them back whole."""
    w, _ = PM.mk_weights(torch.Generator().manual_seed(0), 3, device="cpu")
    img = PM.stage_chain(w)
    _stages_read_back(img.data.numpy(), w.view(torch.int16).numpy(),
                      STAGE_K[torch.bfloat16])
    assert torch.equal(PM.unstage_chain(img).view(torch.int16),
                       w.view(torch.int16))


def test_bign_image_reads_back_its_weights():
    """``stage_bign``'s image: per pair, W1's two 256-row halves (four
    stages of 64 bf16 input channels each), then W2's eight stages, each
    read as the kernel's B holding those weights; ``unstage`` gives both
    back whole."""
    P = 3
    g = torch.Generator().manual_seed(0)
    w1, w2 = PM.variant_weights("bigN", g, "cpu", n_layers=2 * P)
    img = PM.stage_bign(w1, w2)
    data = img.data.numpy().reshape(P, 2, -1)
    k = STAGE_K[torch.bfloat16]
    for p in range(P):
        _stages_read_back(data[p, 0], w1[p].view(torch.int16).numpy()
                          .reshape(2, PM.W, PM.W), k)
        _stages_read_back(data[p, 1], w2[p:p + 1].view(torch.int16).numpy(),
                          k)
    b1, b2 = PM.unstage_bign(img)
    assert torch.equal(b1.view(torch.int16), w1.view(torch.int16))
    assert torch.equal(b2.view(torch.int16), w2.view(torch.int16))


@pytest.mark.parametrize("which", ["int8_static", "wall"])
def test_int8_chain_image_reads_back_its_weights(which):
    """``stage_int8_chain``'s image: each layer's two stages of 128 int8
    input channels, read as the kernel's B, hold the weights; ``unstage``
    gives them back whole; the scale table is the scales as given."""
    if which == "wall":
        wq, s = PW.make_weights(torch.Generator().manual_seed(0), 3, "cpu")
    else:
        wq, s = PM.variant_weights(which, torch.Generator().manual_seed(0),
                                   "cpu", n_layers=3)
    img = PM.stage_int8_chain(wq, s)
    _stages_read_back(img.data.numpy(), wq.numpy(), STAGE_K[torch.int8])
    assert torch.equal(PM.unstage_int8_chain(img), wq)
    assert torch.equal(img.table, s)


@pytest.mark.parametrize("case", ["stale", "other_weights", "other_probe",
                                  "bare_bytes"])
def test_a_stale_or_foreign_bign_or_int8_chain_image_is_refused(case):
    """bigN's and the int8 chain's wrappers take only the image of the
    tensors they are given, as they are: an edit after staging (of W2, of
    the scales), another tensor, the other probe's image or the bare bytes
    raise ValueError."""
    g = torch.Generator().manual_seed(2)
    w1, w2 = PM.variant_weights("bigN", g, "cpu", n_layers=4)
    wq, s = PM.variant_weights("int8_static", g, "cpu", n_layers=2)
    bimg, qimg = PM.stage_bign(w1, w2), PM.stage_int8_chain(wq, s)
    PM.check_bign_image(bimg, w1, w2)
    PM.check_int8_chain_image(qimg, wq, s)
    if case == "stale":
        w2[0, 0, 0] += 1
        s[0, 0] += 1
    bad = {"stale": (bimg, qimg),
           "other_weights": (PM.stage_bign(w1, w2.clone()),
                             PM.stage_int8_chain(wq, s.clone())),
           "other_probe": (qimg, bimg),
           "bare_bytes": (bimg.data, qimg.data)}[case]
    with pytest.raises(ValueError):
        PM.check_bign_image(bad[0], w1, w2)
    with pytest.raises(ValueError):
        PM.check_int8_chain_image(bad[1], wq, s)


@pytest.mark.parametrize("body", ["int8", "int8_fold"])
def test_resmlp_table_is_the_plain_products(body):
    """The epilogue table, as the kernel's one-FMA dequantize takes it: a
    block's first layer (m1, b1), folded (m1 * inv_a, b1 * inv_a), its
    second (m2 * rs, b2 * rs), each the plain version's f32 product bit for
    bit; laid out as the kernel reads it, (m[c], b[c], m[c+1], b[c+1]) a
    column pair."""
    w, m, b = PI.variant_weights("int8_resmlp", "cpu", n_blocks=3)
    table = PI.stage_resmlp(w, m, b, body).table
    inv_a = torch.tensor(PI.INV_A, dtype=torch.float32)
    rs = torch.tensor(PI.RS, dtype=torch.float32)
    for i in range(3):
        m1, b1, m2, b2 = m[2 * i], b[2 * i], m[2 * i + 1], b[2 * i + 1]
        if body == "int8_fold":
            m1, b1 = m1 * inv_a, b1 * inv_a
        for l, (mm, bb) in enumerate(((m1, b1), (m2 * rs, b2 * rs))):
            assert torch.equal(table[2 * i + l, :, 0], mm)
            assert torch.equal(table[2 * i + l, :, 1], bb)
    pairs = table.view(-1, 128, 4)    # the kernel's float4 a column pair
    assert torch.equal(pairs[:, 5, 0], table[:, 10, 0])
    assert torch.equal(pairs[:, 5, 3], table[:, 11, 1])


@pytest.mark.parametrize("case", ["stale", "other_weights", "other_body",
                                  "bare_bytes"])
def test_a_stale_or_foreign_image_is_refused(case):
    """The wrappers take only the image of the tensors they are given, as
    they are: an edit after staging, another tensor, another body or the
    bare bytes raise ValueError (the checks run on the CPU too)."""
    w, m, b = PI.variant_weights("int8_resmlp", "cpu", n_blocks=1)
    img = PI.stage_resmlp(w, m, b, "int8")
    PI.check_resmlp_image(img, w, m, b, "int8")
    wc, _ = PM.mk_weights(torch.Generator().manual_seed(1), 2, device="cpu")
    cimg = PM.stage_chain(wc)
    PM.check_chain_image(cimg, wc)
    if case == "stale":
        m[0, 0] += 1
        wc[0, 0, 0] += 1
    bad = {"stale": (img, cimg),
           "other_weights": (PI.stage_resmlp(w.clone(), m, b, "int8"),
                             PM.stage_chain(wc.clone())),
           "other_body": (PI.stage_resmlp(w, m, b, "int8_fold"), cimg),
           "bare_bytes": (img.data, cimg.data)}[case]
    with pytest.raises(ValueError):
        PI.check_resmlp_image(bad[0], w, m, b, "int8")
    if case != "other_body":
        with pytest.raises(ValueError):
            PM.check_chain_image(bad[1], wc)


def _mm_k16(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [N, 256] bf16 times w [256 out, 256 in] bf16 in the kernels' k
    order: an f32 accumulator takes one wgmma k16 step at a time, each
    step's sum exact and rounded once to f32 as it is added (an IEEE
    rounding; the card's tensor cores truncate, ROADMAP C)."""
    hd, wd = h.double(), w.double()
    acc = torch.zeros((h.shape[0], w.shape[0]), dtype=torch.float32)
    for k0 in range(0, h.shape[1], 16):
        acc = (acc.double() + hd[:, k0:k0 + 16]
               @ wd[:, k0:k0 + 16].T).float()
    return acc


def _chain_k16(x, w, b, mode):
    """``chain_ref`` with its products in the kernel's k order."""
    h = x.to(torch.bfloat16)
    for i in range(w.shape[0]):
        acc = _mm_k16(h, w[i])
        if mode == "full":
            acc = torch.relu(acc + b[i])
        elif mode == "lean":
            acc = torch.relu(acc.to(torch.bfloat16).float()
                             + b[i].to(torch.bfloat16).float())
        h = acc.to(torch.bfloat16)
    return h.float()


def _control_k16(x, w, b):
    """``resmlp_ref``'s bf16 control with its products in the kernel's k
    order."""
    rs = torch.tensor(PI.RS, dtype=torch.float32)
    h = x.to(torch.bfloat16)
    for i in range(w.shape[0] // 2):
        t = torch.relu(_mm_k16(h, w[2 * i]) + b[2 * i]).to(torch.bfloat16)
        h = ((_mm_k16(t, w[2 * i + 1]) + b[2 * i + 1]) * rs
             + h.float()).to(torch.bfloat16)
    return h.float()


def _bign_k16(x, w1, w2):
    """``bign_ref`` with its products in the kernel's k order: the second
    product's K = 512 summed as one accumulator over 32 k16 steps, a's
    first half (from A0) then its second."""
    h = x.to(torch.bfloat16)
    for p in range(w1.shape[0]):
        a = torch.relu(_mm_k16(h, w1[p])).to(torch.bfloat16)
        h = torch.relu(_mm_k16(a, w2[p])).to(torch.bfloat16)
    return h.float()


def _rel(got, want):
    d = (got - want).double()
    top = float(want.abs().max())
    return float(d.abs().max()) / top, float(d.pow(2).mean().sqrt()) / top


@pytest.mark.parametrize("depth", ["shallow", "deep"])
@pytest.mark.parametrize("mode", sorted(PM.MODES))
def test_chain_k_order_keeps_the_probes_limits(mode, depth):
    """The chain's three modes with their sums in the kernel's k order
    (16 channels a wgmma step) against the plain version, at chip_smoke's
    inputs' scale and its limits: 8 layers within ``TOL_PROBE_BF16``'s
    shallow pair, 86 within its deep one."""
    L = 8 if depth == "shallow" else PM.N_LAYERS
    g = torch.Generator().manual_seed(cs.SEED + 71)
    w, b = PM.mk_weights(g, L, device="cpu")
    x = torch.randn((256, PM.W), generator=g)
    got, want = _chain_k16(x, w, b, mode), PM.chain_ref(x, w, b, mode)
    tol = cs.TOL_PROBE_BF16[depth]
    rel = _rel(got, want)
    assert rel[0] <= tol[0] and rel[1] <= tol[1], rel


@pytest.mark.parametrize("depth", ["shallow", "deep"])
def test_bign_k_order_keeps_the_probes_limits(depth):
    """bigN with its sums in the kernel's k order (16 channels a wgmma step,
    K = 512 in the second product of each pair) against the plain version,
    at chip_smoke's inputs' scale and its limits: 4 pairs within
    ``TOL_PROBE_BF16``'s shallow pair, 43 within its deep one."""
    P = 4 if depth == "shallow" else PM.N_LAYERS // 2
    g = torch.Generator().manual_seed(cs.SEED + 72)
    w1, w2 = PM.variant_weights("bigN", g, "cpu", n_layers=2 * P)
    x = torch.randn((256, PM.W), generator=g)
    got, want = _bign_k16(x, w1, w2), PM.bign_ref(x, w1, w2)
    tol = cs.TOL_PROBE_BF16[depth]
    rel = _rel(got, want)
    assert rel[0] <= tol[0] and rel[1] <= tol[1], rel


@pytest.mark.parametrize("case", ["probe", "largest_sum"])
def test_mxu_only_as_one_accumulator_equals_the_plain_version(case):
    """The wall's ``mxu_only`` as its kernel computes it, every layer's
    product added into one int32 accumulator and converted to f32 once,
    equals ``wall_ref`` (an f32 sum layer by layer) bit for bit: on the
    probe's weights at full depth, and where the sum is the largest the
    probe's weights allow, 86 * 256 * 127 * 4 (every q 127, every weight
    -4), still below 2^24."""
    L = PW.N_LAYERS
    if case == "probe":
        w, m = PW.make_weights(torch.Generator().manual_seed(cs.SEED + 81),
                               L, "cpu")
        x = torch.randn((256, PW.W), generator=torch.Generator(
            ).manual_seed(cs.SEED + 80))
    else:
        w = torch.full((L, PW.W, PW.W), -4, dtype=torch.int8)
        m = torch.full((L, PW.W), PW.M_SCALE)
        x = torch.full((64, PW.W), 10.0)
    q = F._q8(x, torch.tensor(PW.INV)).to(torch.int64)
    acc = torch.zeros((x.shape[0], PW.W), dtype=torch.int64)
    for i in range(L):
        acc += q @ w[i].to(torch.int64).T
    got = acc.to(torch.int32).float()
    want = PW.wall_ref(x, w, m, "mxu_only")
    assert torch.equal(got, want)
    if case == "largest_sum":
        assert int(acc.abs().max()) == L * PW.W * 127 * 4 < 2 ** 24


@pytest.mark.parametrize("n_blocks", [cs.PROBE_RESMLP_SHALLOW,
                                      PI.N_BLOCKS])
def test_control_k_order_keeps_the_probes_limits(n_blocks):
    """The ResMLP bf16 control with its sums in the kernel's k order against
    the plain version at chip_smoke's limits: 4 blocks (8 layers) within
    ``TOL_PROBE_RESMLP_BF16_SHALLOW``, 43 (86 layers) within
    ``TOL_PROBE_BF16``'s deep pair."""
    w, _, b = PI.variant_weights("bf16_resmlp", "cpu", n_blocks=n_blocks)
    x = torch.randn((256, PI.W), generator=torch.Generator().manual_seed(
        cs.SEED + 80))
    got = _control_k16(x, w, b)
    want = PI.resmlp_ref(x, w, None, b, body="bf16")
    tol = (cs.TOL_PROBE_RESMLP_BF16_SHALLOW
           if n_blocks == cs.PROBE_RESMLP_SHALLOW else cs.TOL_PROBE_BF16["deep"])
    rel = _rel(got, want)
    assert rel[0] <= tol[0] and rel[1] <= tol[1], rel


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("module,name", [("exp/probe_mxu", "stage_chain"),
                                         ("exp/probe_int8", "stage_resmlp"),
                                         ("exp/probe_mxu", "stage_bign"),
                                         ("exp/probe_mxu",
                                          "stage_int8_chain")])
def test_parent_interface_is_read_from_its_sources(tmp_path, module, name,
                                                   staged):
    """A parent comparison calls a parent's chain or body probe through this
    checkout's wrapper only where the parent's module defines the staging
    (its kernel takes the image); an older parent's takes the packed
    weights. This checkout's own sources read as staged."""
    f = tmp_path / "r2l_tpu_torch" / f"{module}.py"
    f.parent.mkdir(parents=True)
    f.write_text(f"def {name if staged else 'other'}(w):\n    return w\n")
    assert _harness.parent_defines(str(tmp_path), module, name) == staged
    assert _harness.parent_defines(str(cs.REPO), module, name)


@pytest.mark.parametrize("exact,delta", [(True, 1e-6), (False, 0.5),
                                         (False, float("nan"))])
def test_parent_probe_refuses_builds_that_disagree(exact, delta):
    """``parent_probe`` holds this checkout's output to the parent's before
    it times them: an int8 probe bit for bit, a bf16 one within PARENT_REL
    (twice chip_smoke's deep limit) of the parent's largest |output|; a
    NaN fails too."""
    assert _harness.PARENT_REL == 2 * cs.TOL_PROBE_BF16["deep"][0]
    want = torch.ones((4, PM.W))
    got = want + delta
    with pytest.raises(AssertionError, match="differs from the parent"):
        _harness.parent_probe("p", "probe_chain", lambda: got, lambda: want,
                              [], exact, _harness.Log(), reps=1)


def test_parent_probe_holds_equal_all_zero_outputs(monkeypatch):
    """Two builds whose outputs are both all 0 (the static int8 chains decay
    to 0 by 86 layers) agree bit for bit, with no 0 / 0 in the check; the
    record says so."""
    monkeypatch.setattr(_harness, "in_turns",
                        lambda *a, **k: ([1.0], [1.0], None))
    recs = []
    zeros = torch.zeros((4, PM.W))
    _harness.parent_probe("p", "probe_int8_chain", lambda: zeros,
                          lambda: zeros.clone(), [], True, recs.append,
                          reps=1)
    assert recs[0]["bit_for_bit"] and recs[0]["max_rel_diff"] == 0.0
