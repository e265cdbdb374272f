"""The port's row copies (kme_tpu_torch/ops/rowdma.py) against the JAX
package's Pallas kernels (kme_tpu/ops/rowdma.py, interpret mode on the
CPU) — one planar plane per call, and both position planes per call
with the int64 join/split fused in, against the JAX package's
gather + `join_rows` and `split_rows` + scatter — and its planar int64
layout helpers against the JAX package's.

Tolerance 0: every value is an int32 bit pattern. On CPU tensors the
wrappers take the plain versions (`index_select`, a masked
`index_copy_`) and count no launch; the CUDA kernels are held against
those plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kme_tpu.ops import rowdma as JR
from kme_tpu_torch.ops import rowdma as R

torch.set_num_threads(1)

EXTREMES = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31, -2**31 - 1, 2**32 - 1,
                     2**32, 2**62, -2**62, 2**63 - 1, -2**63], np.int64)


def _case(W, S=9, SUB=2, seed=0):
    """Seeded (S, SUB, 128) plane, lanes with repeated scrap lanes and
    distinct real lanes, and update rows."""
    rng = np.random.default_rng(seed + W)
    flat = rng.integers(-2**31, 2**31, (S, SUB, 128), dtype=np.int64
                        ).astype(np.int32)
    k = min(max(W - 2, 1), S - 1)
    lanes = np.full(W, S - 1, np.int32)
    lanes[rng.choice(W, k, replace=False)] = rng.choice(S - 1, k,
                                                        replace=False)
    rows = rng.integers(-2**31, 2**31, (W, SUB, 128), dtype=np.int64
                        ).astype(np.int32)
    return flat, lanes, rows


@pytest.mark.parametrize("W", [1, 4, 8])
def test_plain_gather_and_scatter_equal_pallas_kernels(W):
    flat, lanes, rows = _case(W)
    S = flat.shape[0]
    before = dict(R.LAUNCHES)
    got = R.gather_lane_rows(torch.from_numpy(flat), torch.from_numpy(lanes))
    want = np.asarray(JR.gather_lane_rows(jnp.asarray(flat),
                                          jnp.asarray(lanes)))
    np.testing.assert_array_equal(got.numpy(), want)

    t_flat = torch.from_numpy(flat.copy())
    out = R.scatter_lane_rows(t_flat, torch.from_numpy(lanes),
                              torch.from_numpy(rows), S - 1)
    assert out is t_flat            # in place
    want = np.asarray(JR.scatter_lane_rows(jnp.asarray(flat),
                                           jnp.asarray(lanes),
                                           jnp.asarray(rows), S - 1))
    np.testing.assert_array_equal(t_flat.numpy(), want)
    # the scrap lane kept its row; the plain versions count no launch
    np.testing.assert_array_equal(t_flat.numpy()[S - 1], flat[S - 1])
    assert R.LAUNCHES == before


def _pos_case(W, S=17, SUB=2, seed=0):
    """Two seeded int64 position planes packed planar, with every int64
    extreme in them; lanes with distinct real lanes and repeated scrap
    lanes; (W, A) int64 update blocks, extremes included."""
    rng = np.random.default_rng(seed + 10 * W)
    A = SUB * 64

    def int64s(shape):
        v = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
        pick = rng.random(shape) < 0.3
        v[pick] = rng.choice(EXTREMES, int(pick.sum()))
        v.reshape(-1)[:len(EXTREMES)] = EXTREMES
        return v

    planes = [R.pack64_np(int64s((S, A)), S) for _ in "ab"]
    k = min(max(W - 2, 1), S - 1)
    lanes = np.full(W, S - 1, np.int32)
    lanes[rng.choice(W, k, replace=False)] = rng.choice(S - 1, k,
                                                        replace=False)
    return planes, lanes, [int64s((W, A)) for _ in "ab"]


@pytest.mark.parametrize("W", [1, 8, 16])
def test_pos_plain_versions_equal_pallas_join_and_split(W):
    """gather_pos_rows == the JAX package's join_rows(gather_lane_rows)
    on each plane, scatter_pos_rows == its scatter_lane_rows of
    split_rows, bit for bit; the scrap lane keeps its rows."""
    planes, lanes, blks = _pos_case(W)
    S = planes[0].shape[0]
    t_lanes = torch.from_numpy(lanes)
    before = dict(R.LAUNCHES)
    got = R.gather_pos_rows(*[torch.from_numpy(p) for p in planes], t_lanes)
    for g, plane in zip(got, planes):
        want = np.asarray(JR.join_rows(JR.gather_lane_rows(
            jnp.asarray(plane), jnp.asarray(lanes))))
        assert g.dtype == torch.int64 and g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want)

    flats = [torch.from_numpy(p.copy()) for p in planes]
    out = R.scatter_pos_rows(*flats, t_lanes,
                             *[torch.from_numpy(b) for b in blks], S - 1)
    assert out[0] is flats[0] and out[1] is flats[1]    # in place
    real = lanes != S - 1
    for f, plane, b in zip(flats, planes, blks):
        want = np.asarray(JR.scatter_lane_rows(
            jnp.asarray(plane), jnp.asarray(lanes),
            JR.split_rows(jnp.asarray(b)), S - 1))
        np.testing.assert_array_equal(f.numpy(), want)
        np.testing.assert_array_equal(f.numpy()[S - 1], plane[S - 1])
        np.testing.assert_array_equal(
            R.unpack64_np(f.numpy(), S)[lanes[real]], b[real])
    assert R.LAUNCHES == before


def test_replays_add_the_graph_launch_counts():
    """A CUDA graph's launches count when it runs: `replayed` adds the
    counts a capture recorded, once per replay."""
    before = dict(R.LAUNCHES)
    try:
        R.replayed({"gather_pos": 1, "scatter_pos": 1, "gather": 0}, 7)
        R.replayed({"gather_pos": 1, "scatter_pos": 1})
        assert {k: R.LAUNCHES[k] - before[k] for k in before} == {
            "gather": 0, "scatter": 0, "gather_pos": 8, "scatter_pos": 8}
    finally:
        R.LAUNCHES.update(before)


def test_planar_layout_round_trips_on_int64_extremes():
    rng = np.random.default_rng(3)
    A = 128
    v = rng.choice(EXTREMES, (5, A))
    v[0, :len(EXTREMES)] = EXTREMES
    packed = R.pack64_np(v, 5)
    np.testing.assert_array_equal(packed, JR.pack64_np(v, 5))
    np.testing.assert_array_equal(R.unpack64_np(packed, 5), v)
    np.testing.assert_array_equal(R.unpack64_np(packed, 5),
                                  JR.unpack64_np(packed, 5))
    # join/split on tensors equal the JAX package's on the same rows
    rows = torch.from_numpy(packed)
    blk = R.join_rows(rows)
    np.testing.assert_array_equal(blk.numpy(), v)
    np.testing.assert_array_equal(
        blk.numpy(), np.asarray(JR.join_rows(jnp.asarray(packed))))
    back = R.split_rows(blk)
    np.testing.assert_array_equal(back.numpy(), packed)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JR.split_rows(jnp.asarray(v))))
    lo, hi = R.split64(torch.from_numpy(EXTREMES))
    jlo, jhi = JR.split64(jnp.asarray(EXTREMES))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(R.join64(lo, hi).numpy(), EXTREMES)
    assert R.row_shape(8192) == (64, 128)
    with pytest.raises(ValueError):
        R.row_shape(100)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    flat = torch.zeros((4, 2, 128), dtype=torch.int32)
    lanes = torch.zeros(2, dtype=torch.int32)
    rows = torch.zeros((2, 2, 128), dtype=torch.int32)
    for bad_flat in (flat.to(torch.int64), flat[:, :, :64],
                     flat.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="flat"):
            R.gather_lane_rows(bad_flat, lanes)
    with pytest.raises(ValueError, match="lanes"):
        R.gather_lane_rows(flat, lanes.to(torch.int64))
    with pytest.raises(ValueError, match="rows"):
        R.scatter_lane_rows(flat, lanes, rows[:, :1].contiguous(), 3)
    with pytest.raises(ValueError, match="rows"):
        R.scatter_lane_rows(flat, lanes, rows.to(torch.int64), 3)


def test_pos_wrappers_refuse_what_the_kernels_do_not_take():
    pa = torch.zeros((4, 2, 128), dtype=torch.int32)
    lanes = torch.zeros(2, dtype=torch.int32)
    blk = torch.zeros((2, 128), dtype=torch.int64)
    with pytest.raises(ValueError, match="pv"):
        R.gather_pos_rows(pa, pa[:3].contiguous(), lanes)
    with pytest.raises(ValueError, match="flat"):
        R.gather_pos_rows(pa, pa.to(torch.int64), lanes)
    with pytest.raises(ValueError, match="lanes"):
        R.gather_pos_rows(pa, pa, lanes.to(torch.int64))
    with pytest.raises(ValueError, match="pa_blk"):
        R.scatter_pos_rows(pa, pa.clone(), lanes, blk.to(torch.int32), blk,
                           3)
    with pytest.raises(ValueError, match="pv_blk"):
        R.scatter_pos_rows(pa, pa.clone(), lanes, blk, blk[:, :64], 3)
    with pytest.raises(ValueError, match="pv_blk"):
        R.scatter_pos_rows(pa, pa.clone(), lanes, blk, blk.t(), 3)
