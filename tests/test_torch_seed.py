"""The keyframe reseed gated on a predicate (``tpuflow_torch.kernels.seed``)
and the VO front end around it, against ``tpuflow`` on the CPU.

On a CPU tensor the seed's wrapper runs its plain version with the
predicate applied as a select; the CUDA kernel (``csrc/seed.cu``) is held
against that plain version bit for bit in ``tests/test_torch_gpu.py``.
Limits, all exact:

- the gated seed with a true predicate equals ``tpuflow.vo.tracking.
  seed_grid`` bit for bit at margins 0, 3, 13 and 20 (cells wholly in the
  stripe: all ``-inf``, index 0), on noise, blurred noise, constant
  patches (exact ties in every cell) and a flat frame, at 120x160 and at
  121x163 (sides not multiples of the grid step), grid steps 16 and 8;
  with a false predicate every cell is dead;
- the reseed counter counts exactly the calls whose predicate was true
  (and every ungated call);
- the front end (``backend="torch"`` and ``backend="cuda"`` on CPU
  tensors) steps as ``tpuflow``'s (``backend="jnp"``) at keyframe strides
  1, 2 and 3: alive, landmark ids, the landmark counter, ages and the
  loss log identical, positions bit for bit. The frames do not move (the
  flow is exactly 0 in both packages), and between steps the same slots
  are killed in both states, or every slot is set alive inside the cull
  margin: so the steps include keyframes with dead slots (the branch
  taken), fully tracked keyframes (``any(~alive)`` false) and dead slots
  off a keyframe (both skipped). The counter reads the taken branches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow.vo import device_loop as jdl
from tpuflow.vo import tracking as jtr
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import launch_counts, seed
from tpuflow_torch.vo import device_loop, tracking


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does: small
    ops otherwise wait on busy cores beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(source: str, shape) -> np.ndarray:
    rng = np.random.default_rng(len(source) + shape[1])
    if source == "noise":
        return rng.uniform(0, 255, shape).astype(np.float32)
    if source == "texture":
        return np.round(gaussian_filter(rng.uniform(0, 255, shape), 2.0)).astype(np.float32)
    if source == "patches":  # 8x8 constant patches: every cell's maxima tie
        levels = rng.integers(0, 255, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        return np.kron(levels, np.ones((8, 8)))[: shape[0], : shape[1]].astype(np.float32)
    return np.full(shape, 7.0, np.float32)  # flat: every response 0


@pytest.mark.parametrize("shape", [(120, 160), (121, 163)])
@pytest.mark.parametrize("margin", [0, 3, 13, 20])
@pytest.mark.parametrize("source", ["noise", "texture", "patches", "flat"])
def test_gated_seed_equals_the_reference(shape, margin, source):
    frame = _frame(source, shape)
    want = jtr.seed_grid(jnp.asarray(frame), grid_step=16, margin=margin)
    t = torch.from_numpy(frame)
    before = launch_counts()
    xy, alive = seed.seed_grid(t, 16, margin=margin, predicate=torch.tensor(True))
    assert launch_counts() == before  # a CPU tensor: the plain version ran
    np.testing.assert_array_equal(xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want.alive))
    plain = tracking.seed_grid(t, grid_step=16, margin=margin)
    for got, w in zip(plain, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    _, off = seed.seed_grid(t, 16, margin=margin, predicate=torch.tensor(False))
    assert off.shape == alive.shape and not bool(off.any())
    if margin == 20:  # the first cell lies wholly in the stripe: -inf, index 0
        assert xy[0].tolist() == [0.0, 0.0] and not bool(alive[0])


@pytest.mark.parametrize("margin", [0, 5])
def test_gated_seed_at_grid_step_8(margin):
    frame = _frame("texture", (121, 163))
    want = jtr.seed_grid(jnp.asarray(frame), grid_step=8, margin=margin)
    xy, alive = seed.seed_grid(torch.from_numpy(frame), 8, margin=margin)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want.alive))


def test_counter_counts_the_taken_calls():
    t = torch.from_numpy(_frame("texture", (64, 80)))
    taken = torch.zeros(1, dtype=torch.int32)
    preds = [True, False, False, True, True, False]
    for p in preds:
        seed.seed_grid(t, 16, predicate=torch.tensor(p), taken=taken)
    assert int(taken) == sum(preds)
    seed.seed_grid(t, 16, taken=taken)  # ungated: seeds, and counts
    assert int(taken) == sum(preds) + 1


def test_wrapper_refuses_what_it_does_not_take():
    t = torch.zeros(32, 32)
    with pytest.raises(ValueError):
        seed.seed_grid(t[None], 16)
    with pytest.raises(ValueError):
        seed.seed_grid(t, 0)
    with pytest.raises(ValueError):
        seed.seed_grid(t, 16, margin=-1)
    with pytest.raises(ValueError):
        seed.seed_grid(t, 16, predicate=torch.tensor(1))
    with pytest.raises(ValueError):
        seed.seed_grid(t, 16, predicate=torch.tensor([True, False]))
    with pytest.raises(ValueError):
        seed.seed_grid(t, 16, taken=torch.zeros(1, dtype=torch.int64))


# Between steps: "kill" kills every third slot (offset by the step) in
# both states; "all" sets every slot alive, moved inside the cull margin.
PATTERN = ("kill", "all", "kill", "kill", "all", "kill")
H, W = 120, 160


def _edit(state, step: int, kind: str, xp):
    """The same edit of a tpuflow (xp = jnp) or a port (xp = torch) state."""
    n = state.alive.shape[0]
    idx = np.arange(n)
    if kind == "kill":
        alive = np.asarray(state.alive) & (idx % 3 != step % 3)
        xy = np.asarray(state.xy)
    else:
        alive = np.ones(n, bool)
        xy = np.asarray(state.xy).copy()
        xy[:, 0] = np.clip(xy[:, 0], 4.0, W - 5.0)
        xy[:, 1] = np.clip(xy[:, 1], 4.0, H - 5.0)
    conv = jnp.asarray if xp is jnp else torch.from_numpy
    return state._replace(alive=conv(alive), xy=conv(np.ascontiguousarray(xy)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_front_end_gated_reseed_matches_the_reference(backend, stride):
    frame = _frame("texture", (H, W))
    jfe = jdl.FrontEnd(grid_step=16, keyframe_stride=stride, backend="jnp")
    tfe = device_loop.FrontEnd(grid_step=16, keyframe_stride=stride, backend=backend)
    js, _ = jfe.init(frame)
    ts, _ = tfe.init(torch.from_numpy(frame))
    counter = pyramidal.counters.reseeds(torch.device("cpu"))
    start = int(counter)
    taken = skipped_full = skipped_off = 0
    for i, kind in enumerate(PATTERN, start=1):
        js, ts = _edit(js, i, kind, jnp), _edit(ts, i, kind, torch)
        n_before = int(ts.n_landmarks)
        js, jo = jfe.step(js, frame)
        ts, to = tfe.step(ts, torch.from_numpy(frame))
        for got, want in zip(to, jo):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for f in ("xy", "start_xy", "age", "alive", "track_lm", "n_landmarks", "frame_index",
                  "max_alive", "tracking_lost", "loss_frames", "loss_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f)
        keyframe = i % stride == 0
        if kind == "kill" and keyframe:
            taken += 1
            assert int(ts.n_landmarks) > n_before  # dead slots reseeded, new ids
        else:
            skipped_full += kind == "all" and keyframe
            skipped_off += kind == "kill" and not keyframe
            assert int(ts.n_landmarks) == n_before
    assert int(counter) - start == taken
    assert taken and (skipped_full if stride < 3 else True)
    assert skipped_off or stride == 1
