"""The merge of kernel 1's two designs (csrc/fps.cu), emulated on the CPU.

Large rows run as a cluster of C CTAs, each holding a contiguous slice of
the row; within a CTA (and within the one warp of a small row) every thread
holds a strided set of points. Each step takes the per-thread argmax (strict
> over ascending indices: the lowest index wins), merges threads and then
the C slice candidates by (d2 descending, index ascending), and every CTA
applies the same merge. Emulated step by step in f32 with numpy and held
exactly against the JAX scan (ws3d_tpu/ops/sampling.py:_fps_scan) and the
port's plain version, on rows whose duplicated points put equal min-d2
values on both sides of slice and thread borders (as the EVAL loader's
padding does)."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.ops.sampling import _fps_scan
from ws3d_tpu_torch.ops.sampling import fps_plain

INT_MAX = np.iinfo(np.int32).max


def _best(md, ids):
    """Argmax of md over the points `ids` (ascending), lowest index on
    ties; (-2, INT_MAX) for an empty set, as the kernel's empty thread."""
    if ids.size == 0:
        return -2.0, INT_MAX
    k = int(np.argmax(md[ids]))              # numpy: the first maximum
    return float(md[ids[k]]), int(ids[k])


def _merge(cands):
    """(d2 descending, index ascending): the kernel's merge order."""
    return min(cands, key=lambda c: (-c[0], c[1]))


def fps_sliced(row: np.ndarray, npoint: int, C: int, T: int) -> np.ndarray:
    """One row (N, 3) f32 through C contiguous slices of T strided threads."""
    N = row.shape[0]
    size = -(-N // C)
    groups = []
    for c in range(C):
        ids = np.arange(c * size, min(N, (c + 1) * size))
        groups.append([ids[tid::T] for tid in range(T)])
    md = np.full(N, 1e10, np.float32)
    x, y, z = row[:, 0], row[:, 1], row[:, 2]
    out = np.zeros(npoint, np.int32)
    last = 0
    for it in range(1, npoint):
        dx, dy, dz = x - x[last], y - y[last], z - z[last]
        md = np.minimum(md, (dx * dx + dy * dy) + dz * dz)
        per_cta = [_merge([_best(md, ids) for ids in threads])
                   for threads in groups]
        last = _merge(per_cta)[1]
        out[it] = last
    return out


def _rows(rng, R, N):
    xyz = (rng.randn(R, N, 3) * 4).astype(np.float32)
    src = rng.randint(0, N // 2, (R, N - N // 2))
    xyz[:, N // 2:] = np.take_along_axis(xyz[:, :N // 2], src[..., None], 1)
    # a lattice row: equal min-d2 values everywhere
    g = np.stack(np.meshgrid(np.arange(8.), np.arange(8.), np.arange(N // 64),
                             indexing="ij"), -1).reshape(-1, 3)
    xyz[-1] = g[rng.permutation(N)].astype(np.float32)
    return xyz


@pytest.mark.parametrize("C,T", [(1, 32), (1, 64), (2, 32), (8, 8),
                                 (16, 4)])
def test_sliced_merge_is_exact(rng, C, T):
    xyz = _rows(rng, 3, 256)
    npoint = 64
    ref = np.asarray(_fps_scan(jnp.asarray(xyz), npoint))
    np.testing.assert_array_equal(n(fps_plain(t(xyz), npoint)), ref)
    got = np.stack([fps_sliced(r, npoint, C, T) for r in xyz])
    np.testing.assert_array_equal(got, ref)


def test_ties_cross_slice_borders(rng):
    """A point and its duplicate in different slices: the merge must take
    the lower index, as argmax does."""
    xyz = _rows(rng, 2, 128)
    xyz[:, 100] = xyz[:, 3]
    xyz[:, 64] = xyz[:, 63]
    ref = np.asarray(_fps_scan(jnp.asarray(xyz), 48))
    for C in (2, 8, 16):
        got = np.stack([fps_sliced(r, 48, C, 4) for r in xyz])
        np.testing.assert_array_equal(got, ref)
