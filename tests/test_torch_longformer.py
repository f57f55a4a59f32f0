"""The port's Longformer (fastertransformer4codefuse_tpu_torch/models/longformer.py)
against the JAX package's ``encode`` and HF ``LongformerModel``, on the tiny
configs of tests/test_longformer.py: local attention only, global tokens,
per-layer windows; through the dense path and the K12 path (its plain
version on the CPU).

Tolerance: rtol 2e-4 / atol 2e-5 in fp32 on every real position and the
pooler, the JAX test's own against HF (summation order; the JAX kernel path
runs the Pallas kernel in interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import longformer as jlf
from fastertransformer4codefuse_tpu_torch.models import longformer as lf
from fastertransformer4codefuse_tpu_torch.models import registry
from fastertransformer4codefuse_tpu_torch.ops import sliding_window as sw
from test_longformer import make_hf

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-5)


def _port_params(hf):
    cfg = lf.config_from_hf_longformer(hf.config)
    return cfg, lf.params_from_hf_longformer_state_dict(cfg, hf.state_dict(), device="cpu")


def _close_on_real(got, want, lens):
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


CASES = {
    # name: (seed, window, layers, B x S ids seed, lens, global rows)
    "local_only": (0, 8, 2, 1, [21, 13], ()),
    "global_tokens": (2, 4, 2, 3, [18, 11], [(0, 0), (0, 9), (1, 0)]),
    "per_layer_windows": (4, [4, 8], 2, 5, [16], ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_encode_matches_hf_and_jax(case, use_kernel):
    seed, window, layers, ids_seed, lens, global_rows = CASES[case]
    hf = make_hf(seed=seed, window=window, layers=layers)
    cfg, params = _port_params(hf)
    jcfg = jlf.config_from_hf_longformer(hf.config)
    jparams = jlf.params_from_hf_longformer_state_dict(jcfg, hf.state_dict())
    B, S = len(lens), max(lens)
    ids = np.random.RandomState(ids_seed).randint(2, 96, size=(B, S)).astype(np.int64)
    am = (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(np.int64)
    gm = np.zeros((B, S), bool)
    for b, r in global_rows:
        gm[b, r] = True
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(am),
                 global_attention_mask=torch.from_numpy(gm.astype(np.int64)) if gm.any() else None)
    lens_np = np.asarray(lens, np.int32)
    want_h, want_p = jlf.encode(jcfg, jparams, jnp.asarray(ids.astype(np.int32)),
                                jnp.asarray(lens_np),
                                global_mask=jnp.asarray(gm) if gm.any() else None,
                                use_kernel=use_kernel)
    launches = sw.sliding_window_attention.launches
    got_h, got_p = lf.encode(cfg, params, torch.from_numpy(ids), torch.from_numpy(lens_np),
                             global_mask=torch.from_numpy(gm) if gm.any() else None,
                             use_kernel=use_kernel)
    assert sw.sliding_window_attention.launches == launches  # CPU: the plain version
    got_h, got_p = got_h.numpy(), got_p.numpy()
    _close_on_real(got_h, np.asarray(want_h), lens)
    np.testing.assert_allclose(got_p, np.asarray(want_p), **TOL)
    _close_on_real(got_h, out.last_hidden_state.numpy(), lens)
    np.testing.assert_allclose(got_p, out.pooler_output.numpy(), **TOL)


def test_kernel_route_matches_dense_route():
    """encode(use_kernel=True) equals the dense path on a batch with no
    global tokens (tests/test_longformer.py's case)."""
    hf = make_hf(seed=8, window=[4, 8], layers=2)
    cfg, params = _port_params(hf)
    ids = torch.from_numpy(np.random.RandomState(9).randint(2, 96, size=(2, 24)))
    lens = torch.tensor([24, 17], dtype=torch.int32)
    dense_h, dense_p = lf.encode(cfg, params, ids, lens)
    kern_h, kern_p = lf.encode(cfg, params, ids, lens, use_kernel=True)
    _close_on_real(kern_h.numpy(), dense_h.numpy(), [24, 17])
    np.testing.assert_allclose(kern_p.numpy(), dense_p.numpy(), **TOL)


def test_skipping_the_global_rows_changes_nothing():
    """With no global_mask the port skips the global-row projections and
    their S x S softmax; an all-False mask runs them and discards them, as
    JAX always does. The two outputs are bit-identical."""
    hf = make_hf(seed=3, window=6, layers=2)
    cfg, params = _port_params(hf)
    ids = torch.from_numpy(np.random.RandomState(4).randint(2, 96, size=(2, 20)))
    lens = torch.tensor([20, 12], dtype=torch.int32)
    skip_h, skip_p = lf.encode(cfg, params, ids, lens)
    run_h, run_p = lf.encode(cfg, params, ids, lens, global_mask=torch.zeros(2, 20, dtype=torch.bool))
    assert torch.equal(skip_h, run_h) and torch.equal(skip_p, run_p)


def test_global_mask_routes_away_from_the_kernel():
    """A global_mask sends the batch to the dense path even with
    use_kernel=True: the same result as use_kernel=False."""
    hf = make_hf(seed=2, window=4, layers=1)
    cfg, params = _port_params(hf)
    ids = torch.from_numpy(np.random.RandomState(10).randint(2, 96, size=(1, 16)))
    lens = torch.tensor([16], dtype=torch.int32)
    gm = torch.zeros(1, 16, dtype=torch.bool)
    gm[0, 0] = True
    a = lf.encode(cfg, params, ids, lens, global_mask=gm, use_kernel=True)
    b = lf.encode(cfg, params, ids, lens, global_mask=gm, use_kernel=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_window_actually_limits_attention():
    """One layer, window 4: an edit outside position 0's window leaves its
    hidden state unchanged, an edit inside changes it."""
    hf = make_hf(seed=6, window=4, layers=1)
    cfg, params = _port_params(hf)
    ids = np.random.RandomState(7).randint(2, 96, size=(1, 24))
    lens = torch.tensor([24], dtype=torch.int32)
    for use_kernel in (False, True):
        base, _ = lf.encode(cfg, params, torch.from_numpy(ids), lens, use_kernel=use_kernel)
        far = ids.copy()
        far[0, 20] = (far[0, 20] + 1) % 94 + 2
        far_h, _ = lf.encode(cfg, params, torch.from_numpy(far), lens, use_kernel=use_kernel)
        assert torch.equal(base[0, 0], far_h[0, 0])
        near = ids.copy()
        near[0, 2] = (near[0, 2] + 1) % 94 + 2
        near_h, _ = lf.encode(cfg, params, torch.from_numpy(near), lens, use_kernel=use_kernel)
        assert (base[0, 0] - near_h[0, 0]).abs().max() > 1e-6


def test_params_from_numpy_and_torch_agree_and_land_on_the_device():
    hf = make_hf(seed=0, window=8, layers=2)
    cfg = lf.config_from_hf_longformer(hf.config)
    sd = hf.state_dict()
    a = lf.params_from_hf_longformer_state_dict(cfg, sd, device="cpu")
    b = lf.params_from_hf_longformer_state_dict(
        cfg, {k: v.numpy() for k, v in sd.items()}, dtype="bf16", device="cpu")
    assert a["layers"]["qg_w"].shape == (2, 32, 32) and a["embed"].dtype == torch.float32
    assert b["layers"]["up_w"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["up_w"].to(torch.bfloat16), b["layers"]["up_w"])
    j = jlf.params_from_hf_longformer_state_dict(cfg, sd)
    for name, t in a["layers"].items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(j["layers"][name]), err_msg=name)


def test_registry_family_encodes():
    fam = registry.get("longformer")
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    ids = np.random.RandomState(0).randint(2, 96, size=(1, 12)).astype(np.int32)
    h, p = fam.encode(cfg, params, ids, np.array([12], np.int32))
    assert h.shape == (1, 12, 32) and p.shape == (1, 32)
    eng = fam.make_engine(cfg, params)
    h2, p2 = eng.encode(ids, np.array([12], np.int32))
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **TOL)
