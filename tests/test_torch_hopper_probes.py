"""The stream probe's and the int8-dL/dx probe's Hopper forms, on the CPU:
the layouts their kernels read (``r2l_train.stage_qdx_weights``' image of
q^T, the S = 4 form's half-stages of K2's image), the int8-dL/dx kernel's
tiles, and that neither translation unit reaches the pre-Hopper engines.
The kernels themselves run on the card (``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch

from r2l_tpu_torch.exp import probe_bwd_qdx as PQ
from r2l_tpu_torch.exp import probe_pipe_lib as PL
from r2l_tpu_torch.kernels import _build
from r2l_tpu_torch.kernels import r2l_fused as F
from r2l_tpu_torch.kernels import r2l_train as T
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


@pytest.mark.parametrize("lib", ["r2l_int8_hopper", "r2l_bwd_qdx"])
def test_hopper_probes_reach_no_pre_hopper_engine(lib):
    """K2's translation unit (which holds the stream probe's forms) and the
    int8-dL/dx probe's include no pre-Hopper engine and issue no mma.sync:
    wgmma only."""
    tu = _translation_unit(lib)
    assert "r2l_engines.cuh" not in tu
    assert "EngineS8" not in tu and "EngineBF16" not in tu
    assert "mma.sync" not in tu
    assert "wgmma.mma_async" in tu
