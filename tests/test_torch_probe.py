"""The write-bandwidth probe (``ops/probe.py``) against the TPU tool's kernel.

``tools/probe_write_bw.py`` runs its sweep when imported and needs the TPU
Pallas backend, so it cannot be imported here; :func:`_tool_kernel` is a
numpy transcription of its kernel body (``tools/probe_write_bw.py:16`` and
``:18-19``).  Both modes are one float32 multiply per value in all three
(numpy, the plain version, the CUDA kernel), so they agree bit for bit
(tolerance 0).  Cases marked ``cuda`` need neither JAX nor the JAX package:

    python -m pytest tests/test_torch_probe.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from infercnvpy_tpu_torch.ops import probe  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _tool_kernel(x: np.ndarray, w: int, mode: str) -> np.ndarray:
    """The TPU kernel's body on one row tile, in numpy."""
    n = x.shape[0]
    if mode == "bcast":
        # o_ref[:] = jnp.broadcast_to(x_ref[:, 0:1], (rt, w)) * 1.000001
        return np.broadcast_to(x[:, 0:1] * np.float32(1.000001), (n, w)).copy()
    out = np.empty((n, w), np.float32)
    for q in range(w // 128):
        # o_ref[:, q * 128 : (q + 1) * 128] = x_ref[:, 0:128] * float(q + 1)
        out[:, q * 128 : (q + 1) * 128] = x[:, 0:128] * np.float32(q + 1)
    return out


def _input(n=64, seed=0):
    return np.random.default_rng(seed).standard_normal((n, probe.X_COLS)).astype(np.float32)


@pytest.mark.parametrize("mode", probe.MODES)
def test_plain_matches_the_tool_kernel(mode):
    x = _input()
    got = probe.write_probe_plain(torch.from_numpy(x), 512, mode)
    assert got.shape == (64, 512) and got.dtype == torch.float32
    npt.assert_array_equal(got.numpy().view(np.uint32), _tool_kernel(x, 512, mode).view(np.uint32))
    # on a CPU tensor the dispatcher takes the plain version
    npt.assert_array_equal(probe.write_probe(torch.from_numpy(x), 512, mode).numpy(), got.numpy())


@pytest.mark.parametrize(
    "w,mode,x_cols,match",
    [(510, "bcast", 256, "multiple of 4"), (500, "blocks", 256, "w % 128"), (512, "blocks", 64, ">= 128 columns"),
     (512, "rows", 256, "mode must be")],
    ids=["bcast_w", "blocks_w", "blocks_x", "mode"],
)
def test_bad_arguments_raise(w, mode, x_cols, match):
    with pytest.raises(ValueError, match=match):
        probe.write_probe_plain(torch.zeros((4, x_cols)), w, mode)


def test_kernel_refuses_a_cpu_tensor():
    before = probe.write_probe_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        probe.write_probe_cuda(torch.zeros((4, 256)), 512, "blocks")
    assert probe.write_probe_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", probe.MODES)
@pytest.mark.parametrize("n,w", [(64, 512), (300, 128 * 37), (probe.N, probe.W)], ids=["small", "odd_rows", "tool"])
def test_kernel_bit_identical_to_plain_on_gpu(cuda, mode, n, w):
    x = torch.from_numpy(_input(n, seed=1)).to(cuda)
    before = probe.write_probe_cuda.launches
    got = probe.write_probe(x, w, mode)
    assert probe.write_probe_cuda.launches == before + 1
    want = probe.write_probe_plain(x, w, mode)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if n == 64:
        npt.assert_array_equal(got.cpu().numpy(), _tool_kernel(x.cpu().numpy(), w, mode))


@pytest.mark.cuda
def test_write_bandwidth_is_positive_and_counts_launches(cuda):
    before = probe.write_probe_cuda.launches
    rate = probe.write_bandwidth(1024, 19968, "blocks", reps=3)
    assert probe.write_probe_cuda.launches == before + 4  # one warm-up, three timed
    assert 0 < rate < 1e5
