"""The port's structured marching tets against the JAX package's, on the
CPU in fp32.

- `marching_tets_topology` at g = 8 and 16 (sphere crop on and off, and a
  case whose caps overflow): every integer output and both counts must be
  equal.
- `marching_tets_verts` within 1e-6, and its gradients w.r.t. sdf and
  deform (through a fixed random cotangent) within 1e-6 relative to the
  largest gradient entry: both evaluate the same lerp op by op in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.mesh import structured_tets as JS
from mvedit_tpu_torch.models.mesh import structured_tets as TS

torch.set_num_threads(2)


def _sdf(g, seed):
    v = JS.StructuredTetGrid(g).verts
    rng = np.random.default_rng(seed)
    sdf = (0.55 - np.linalg.norm(v, axis=-1)
           + 0.15 * np.sin(4 * v[:, 0]) * np.cos(3 * v[:, 1])
           + 0.02 * rng.standard_normal(len(v))).astype(np.float32)
    deform = (0.2 / g * rng.standard_normal(v.shape)).astype(np.float32)
    return sdf, deform


def _caps(g):
    vc = 1 << max(9, (16 * g * g - 1).bit_length())
    return vc, vc + (vc >> 1)


@pytest.mark.parametrize("g,crop,caps", [(8, True, None), (16, True, None),
                                         (16, False, None),
                                         (16, True, (256, 300))])
def test_topology_matches_jax(g, crop, caps):
    vc, fc = caps or _caps(g)
    sdf, _ = _sdf(g, g)
    jg, tg = JS.StructuredTetGrid(g, crop_sphere=crop), \
        TS.StructuredTetGrid(g, crop_sphere=crop)
    ref = JS.marching_tets_topology(jg, jg.arrays(), jnp.asarray(sdf),
                                    vert_cap=vc, face_cap=fc)
    out = TS.marching_tets_topology(tg, tg.arrays(), torch.from_numpy(sdf),
                                    vert_cap=vc, face_cap=fc)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(ref["n_faces"]) > 0
    if caps:   # the overflow case really overflows both caps
        assert int(ref["n_verts"]) > vc and int(ref["n_faces"]) > fc


@pytest.mark.parametrize("g", [8, 16])
def test_verts_and_gradients_match_jax(g):
    vc, fc = _caps(g)
    sdf, deform = _sdf(g, g + 1)
    jg, tg = JS.StructuredTetGrid(g), TS.StructuredTetGrid(g)
    topo_j = JS.marching_tets_topology(jg, jg.arrays(), jnp.asarray(sdf),
                                       vert_cap=vc, face_cap=fc)
    topo_t = TS.marching_tets_topology(tg, tg.arrays(), torch.from_numpy(sdf),
                                       vert_cap=vc, face_cap=fc)
    cot = np.random.default_rng(0).standard_normal((vc, 3)).astype(np.float32)

    def jf(s, d):
        return jnp.sum(JS.marching_tets_verts(jg, topo_j, s, deform=d) * cot)
    (gs_j, gd_j) = jax.grad(jf, argnums=(0, 1))(jnp.asarray(sdf),
                                                jnp.asarray(deform))
    verts_j = np.asarray(JS.marching_tets_verts(jg, topo_j, jnp.asarray(sdf),
                                                deform=jnp.asarray(deform)))
    s = torch.from_numpy(sdf).requires_grad_(True)
    d = torch.from_numpy(deform).requires_grad_(True)
    verts_t = TS.marching_tets_verts(tg, topo_t, s, deform=d)
    (verts_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(verts_t.detach().numpy(), verts_j, atol=1e-6)
    for a, b in ((s.grad.numpy(), np.asarray(gs_j)),
                 (d.grad.numpy(), np.asarray(gd_j))):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max())
    # the fused extraction is the composition of the two halves
    fused = TS.marching_tets_structured(tg, tg.arrays(), torch.from_numpy(sdf),
                                        deform=torch.from_numpy(deform),
                                        vert_cap=vc, face_cap=fc)
    np.testing.assert_array_equal(fused["verts"].numpy(),
                                  verts_t.detach().numpy())
