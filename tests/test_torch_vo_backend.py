"""The VO front end's fast path: one step of ``backend="cuda"`` (the
kernels' plain versions, on CPU tensors) from the state ``tpuflow``'s
``backend="pallas"`` front end reached, in Pallas interpret mode, at
120x160 (``default``: K4 and K5; ``production``: K1, K2 and K3 on 8-bit
frames).

Both start from the same state (``convert.front_end_state_from_reference``).
Limits: alive, ids and the landmark counter identical; positions within
1e-3 px (measured 1.5e-5 px for ``default`` and 2.7e-4 px for
``production``: the pyramidal slices' one-ulp differences, held to 2e-3 px
at the finest level in ``tests/test_torch_pyramidal.py``, sampled at the
tracks).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.ndimage import shift as nd_shift

from tpuflow.core.config import PYRAMID_CONFIGS as JAX_CONFIGS
from tpuflow.eval import patterns as jpatterns
from tpuflow.vo import device_loop as jdl
from tpuflow_torch import convert
from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.kernels import launch_counts
from tpuflow_torch.vo import device_loop


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one CPU thread, as in ``tests/test_torch_vo.py`` (small
    ops wait on busy cores beside the other test workers otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["default", "production"])
def test_cuda_step_matches_pallas_interpret(config):
    base = jpatterns.load_base_texture(160, 120).astype(np.float32)
    # Integer gray levels: the production config's 8-bit contract.
    frames = [np.round(nd_shift(base, (0.3 * i, -1.2 * i), order=1, mode="nearest"))
              for i in range(2)]
    jfe = jdl.FrontEnd(grid_step=16, backend="pallas", config=JAX_CONFIGS[config])
    with pltpu.force_tpu_interpret_mode():
        state, _ = jfe.init(frames[0])
        _, want = jfe.step(state, frames[1])
    fields = {f: [np.asarray(c) for c in v] if f == "carry" else np.asarray(v)
              for f, v in zip(state._fields, state)}
    fe = device_loop.FrontEnd(grid_step=16, backend="cuda", config=PYRAMID_CONFIGS[config])
    before = launch_counts()
    _, got = fe.step(convert.front_end_state_from_reference(fields, "cpu"),
                     torch.from_numpy(frames[1]))
    assert launch_counts() == before  # CPU tensors: the plain versions ran
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal(got.lm.numpy(), np.asarray(want.lm))
    assert int(got.n_landmarks) == int(want.n_landmarks)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0, atol=1e-3)
