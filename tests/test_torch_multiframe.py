"""The multi-frame filters and DeepFilterNet-MF of the port against the JAX
package, on the CPU.

Every function of `models/multiframe.py` on the same seeded complex64
inputs, 1e-5 per op (relative to each output's largest value where a
covariance's scale enters: those outputs reach ~1e2): `psd`, `crm`,
`_tik_reg`, `_enforce_hermitian`, `_prep_cov` (Cholesky factor, Hermitian,
as given), `_mf_weights` (a solve on `_tik_reg`-regularized, well-conditioned
covariances, and the estimated-inverse product), `mf_wf` and `mf_mvdr` in
their four covariance forms, the normalization factors; then
`dfnetmf.forward` for WF and MVDR at `ModelParamsMF`'s default (published)
widths, JAX's random weights carried across, at 1e-4 of each output's
largest value.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import build, check_forward, rand_inputs  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_tpu.models import dfnetmf as j_dfnetmf  # noqa: E402
from deepfilternet_tpu.models import multiframe as j_mf  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.models import dfnetmf as t_dfnetmf  # noqa: E402
from deepfilternet_torch.models import init_model  # noqa: E402
from deepfilternet_torch.models import multiframe as t_mf  # noqa: E402

N = 5  # taps (df_order)


@pytest.fixture(scope="module", autouse=True)
def _fresh_configs():
    """Reset both packages' configs; run torch on one CPU thread (the suite
    runs several workers at once)."""
    j_config.reset()
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    j_config.reset()
    t_config.reset()


def _cplx(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def _spd(seed, shape):
    """Well-conditioned Hermitian positive definite [..., N, N]: A A^H / N + I."""
    a = _cplx(seed, shape + (N, N))
    return (a @ np.conj(np.swapaxes(a, -1, -2)) / N + np.eye(N)).astype(np.complex64)


def _rel_close(got, ref, rel=1e-5):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def test_psd_and_crm():
    x = _cplx(1, (2, 10, 8))
    _rel_close(t_mf.psd(torch.from_numpy(x), N), j_mf.psd(jnp.asarray(x), N))
    c = _cplx(2, (2, 10, 8))
    _rel_close(t_mf.crm(torch.from_numpy(x), torch.from_numpy(c)),
               j_mf.crm(jnp.asarray(x), jnp.asarray(c)))


def test_tik_reg_and_hermitian():
    r = _cplx(3, (2, 4, 3, N, N))
    _rel_close(t_mf._tik_reg(torch.from_numpy(r)), j_mf._tik_reg(jnp.asarray(r)))
    _rel_close(t_mf._tik_reg(torch.from_numpy(r), 1e-3, 1e-2),
               j_mf._tik_reg(jnp.asarray(r), 1e-3, 1e-2))
    _rel_close(t_mf._enforce_hermitian(torch.from_numpy(r)),
               j_mf._enforce_hermitian(jnp.asarray(r)))
    zero = np.zeros((4, 3, 3), np.complex64)
    assert np.all(np.linalg.eigvalsh(t_mf._tik_reg(torch.from_numpy(zero)).numpy()) > 0)


@pytest.mark.parametrize("cholesky,inverse,constraints", [
    (True, True, True), (True, False, False), (False, False, True), (False, True, True),
])
def test_prep_cov(cholesky, inverse, constraints):
    r = _cplx(4, (2, 4, 3, N, N))
    _rel_close(t_mf._prep_cov(torch.from_numpy(r), cholesky, inverse, constraints),
               j_mf._prep_cov(jnp.asarray(r), cholesky, inverse, constraints))


@pytest.mark.parametrize("inverse", [False, True])
def test_mf_weights(inverse):
    """The solve (inverse=False) on regularized, well-conditioned covariances
    and the estimated inverse's product, 1e-5 of the weights' scale."""
    r, ifc = _spd(5, (2, 6, 8)), _cplx(6, (2, 6, 8, N))
    _rel_close(t_mf._mf_weights(torch.from_numpy(r), torch.from_numpy(ifc), inverse, 1e-7, 1e-8),
               j_mf._mf_weights(jnp.asarray(r), jnp.asarray(ifc), inverse, 1e-7, 1e-8))


FORMS = [dict(inverse=False), dict(inverse=True), dict(inverse=False, cholesky_decomp=True),
         dict(inverse=True, cholesky_decomp=True, lookahead=1)]


@pytest.mark.parametrize("form", range(len(FORMS)))
@pytest.mark.parametrize("method", ["mf_wf", "mf_mvdr"])
def test_multiframe_filters(method, form):
    kw = FORMS[form]
    b, t, f, nb_df = 2, 9, 20, 12
    spec = _cplx(7, (b, t, f))
    ifc = _cplx(8, (b, t, nb_df, N))
    if kw.get("cholesky_decomp"):  # a lower factor of a well-conditioned matrix
        r = np.linalg.cholesky(_spd(9, (b, t, nb_df))).astype(np.complex64)
    else:
        r = _spd(9, (b, t, nb_df))
    got = getattr(t_mf, method)(torch.from_numpy(spec), torch.from_numpy(ifc),
                                torch.from_numpy(r), nb_df, N, **kw)
    ref = getattr(j_mf, method)(jnp.asarray(spec), jnp.asarray(ifc), jnp.asarray(r), nb_df, N,
                                **kw)
    _rel_close(got, ref)
    # the bins above nb_df pass through
    np.testing.assert_array_equal(got[..., nb_df:].numpy(), spec[..., nb_df:])


def test_r_factors():
    for inverse in (False, True):
        for chol in (False, True):
            assert t_mf.wf_r_factor(inverse, chol) == j_mf.wf_r_factor(inverse, chol)
            assert t_mf.mvdr_r_factor(inverse, chol) == j_mf.mvdr_r_factor(inverse, chol)


# -- DeepFilterNet-MF ---------------------------------------------------------------


def _mvdr_cancellation(ifc, cov, order):
    """A bin and frame's cancellation factor of MVDR's denominator
    Re(ifc^H R ifc): the sum of its terms' magnitudes over its magnitude, in
    float64, from the heads' outputs."""
    b, t, f, _ = ifc.shape
    ifc = ifc.astype(np.float64).reshape(b, t, f, order, 2)
    cov = cov.astype(np.float64).reshape(b, t, f, order, order, 2)
    ifc_c, cov_c = ifc[..., 0] + 1j * ifc[..., 1], cov[..., 0] + 1j * cov[..., 1]
    den = np.einsum("...n,...nm,...m->...", np.conj(ifc_c), cov_c, ifc_c).real
    mag = np.einsum("...n,...nm,...m->...", np.abs(ifc_c), np.abs(cov_c), np.abs(ifc_c))
    return mag / np.maximum(np.abs(den), 1e-300)


# MVDR divides by Re(ifc^H R ifc). With untrained weights R is no covariance
# (not positive definite) and that sum cancels: its magnitude comes as close
# to 0 as 1.2e-6 on these inputs, against a median of 5.9e-3, and where it
# does the float32 rounding of its terms is multiplied up. Measured: 1.58e-4
# of the output's largest value (331) over all bins, at a bin whose
# denominator is -1.9e-5; the heads' outputs themselves agree to 1.3e-7 and
# 2.4e-7. So the whole output is held at 1e-3 of its largest value, and the
# low-band bins whose denominator cancels by at most 100 (at least 90% of
# them) at the 1e-4 of the other outputs.
MVDR_ALL_BINS_TOL, MVDR_MAX_CANCELLATION = 1e-3, 100.0


@pytest.mark.parametrize("method", ["WF", "MVDR"])
def test_dfnetmf_forward_matches_jax(method):
    """The offline forward at the published widths (the repo has no MF
    checkpoint: JAX's seeded random weights, carried across); every output
    within 1e-4 of its largest value (the ifc and cov heads reach ~1 and
    the filtered spectrum ~1e2 on these inputs), but MVDR's spectrum (see
    MVDR_ALL_BINS_TOL)."""
    model = build(j_dfnetmf.init_dfnetmf, t_dfnetmf.init_dfnetmf,
                  {("MFOP_METHOD", "deepfilternet"): method})
    jp, js, jcfg, tp, ts, tcfg = model
    assert tcfg["mfop_method"] == method and tcfg["mf_est_inverse"] is True
    assert tcfg["conv_ch"] == 16 and tcfg["emb_hidden_dim"] == 256
    inputs = rand_inputs(10, 2, 8, jcfg)
    ref, _ = j_dfnetmf.forward(jp, js, jcfg, *map(jnp.asarray, inputs))
    got, _ = t_dfnetmf.forward(tp, ts, tcfg, *map(torch.from_numpy, inputs))
    flat_g = [got[0], got[1], got[2], *got[3]]
    flat_r = [ref[0], ref[1], ref[2], *ref[3]]
    for name, g, r in zip(("spec_e", "mask", "lsnr", "ifc", "cov"), flat_g, flat_r):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, name
        scale = max(np.abs(r).max(), 1e-30)
        err = np.abs(g - r).max() / scale
        if name == "spec_e" and method == "MVDR":
            assert err <= MVDR_ALL_BINS_TOL, (name, err)
            nb_df = jcfg["nb_df"]
            well = _mvdr_cancellation(np.asarray(ref[3][0]), np.asarray(ref[3][1]),
                                      jcfg["df_order"]) <= MVDR_MAX_CANCELLATION  # [B, T, F']
            assert well.mean() >= 0.9, well.mean()
            lo_err = np.abs(g[..., :nb_df, :] - r[..., :nb_df, :]).max(-1)[well].max()
            assert lo_err / scale <= 1e-4, (name, "well-conditioned bins", lo_err / scale)
            err = np.abs(g[..., nb_df:, :] - r[..., nb_df:, :]).max() / scale
        assert err <= 1e-4, (name, err)
    assert np.isfinite(flat_g[0].numpy()).all()


def test_dfnetmf_mask_only_and_registry():
    """run_df=False skips the multi-frame stage (the ERB-masked spectrum, as
    JAX); the registry builds the family; it has no streaming form."""
    model = build(j_dfnetmf.init_dfnetmf, t_dfnetmf.init_dfnetmf, {})
    jp, js, jcfg, tp, ts, tcfg = model
    model = (jp, js, dict(jcfg, run_df=False), tp, ts, dict(tcfg, run_df=False))
    check_forward(j_dfnetmf, t_dfnetmf, model, rand_inputs(11, 1, 5, jcfg),
                  names=("spec_e", "mask", "lsnr"))
    _, _, cfg, mod = init_model("deepfilternetmf", device="cpu")
    assert mod is t_dfnetmf and cfg["generation"] == "mf"
    assert not hasattr(mod, "streaming_cell")
