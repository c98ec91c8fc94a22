"""The port's export (`deepfilternet_torch/scripts/export.py`) on the CPU.

  * the archive of each family's bundled checkpoint: its members in the JAX
    package's layout, the two `torch.export` programs played back against
    the eager `forward` and `streaming_cell` at 1e-6 of the largest value;
  * the offline program against the JAX package's StableHLO program of the
    same checkpoint, played back on the same seeded inputs, at 1e-4;
  * an archive made with `--skip-hlo` read by both packages' `init_df` to
    the same epoch;
  * every export in one fresh process, then eager use there (the cached
    ERB filterbank must not keep a tensor made under tracing);
  * DeepFilterNet-MF raises, as it has no streaming cell.
"""

import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from _torch_families import REPO  # noqa: E402
from deepfilternet_tpu.config import config as j_config  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.enhance import enhance, init_df  # noqa: E402
from deepfilternet_torch.scripts import export as t_export  # noqa: E402

EXACT = 1e-6   # a program against the eager function it was traced from
TO_JAX = 1e-4  # the offline program against JAX's
FAMILIES = ("dfn3", "dfn2", "dfn1")


def _dir(family):
    return os.path.join(REPO, "pretrained", f"{family}_fixture_demo")


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


# every family's export in one fresh process (so the first use of the
# cached ERB filterbank is under tracing, and each later export follows an
# earlier one), then an eager call
FRESH_PROCESS = """
import sys
import numpy as np, torch
from deepfilternet_torch.enhance import enhance, init_df
from deepfilternet_torch.scripts.export import main
torch.set_num_threads(1)
root, x, out = sys.argv[1:4]
for model_dir, archive in zip(sys.argv[4::2], sys.argv[5::2]):
    main([model_dir, archive, "--device", "cpu"])
model, df_state, _ = init_df(sys.argv[4], device="cpu")
np.save(out, enhance(model, df_state, np.load(x)))
"""


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """{family: path of its exported archive}, all made with the CLI in one
    fresh process that then enhances with the first family eagerly
    (`"eager"`: input and output)."""
    d = tmp_path_factory.mktemp("export")
    x = np.random.default_rng(3).standard_normal((1, 20 * 480)).astype(np.float32) * 0.1
    np.save(d / "x.npy", x)
    out = {family: str(d / f"{family}.tar.gz") for family in FAMILIES}
    pairs = [a for family in FAMILIES for a in (_dir(family), out[family])]
    subprocess.run([sys.executable, "-c", FRESH_PROCESS, str(d), str(d / "x.npy"),
                    str(d / "eager.npy"), *pairs],
                   check=True, env=dict(os.environ, PYTHONPATH=REPO), cwd=str(d))
    out["eager"] = (x, np.load(d / "eager.npy"))
    return out


def _rel(got, ref):
    got, ref = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x) for x in (got, ref))
    assert got.shape == ref.shape and np.isfinite(got).all()
    if not ref.size:
        return 0.0
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _inputs(cfg, seed, t=10):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, t, cfg["freq_bins"], 2), (1, t, cfg["nb_erb"]), (1, t, cfg["nb_df"], 2))]


@pytest.mark.parametrize("family", FAMILIES)
def test_archive_layout(archives, family):
    with tarfile.open(archives[family], "r:gz") as tar:
        names = tar.getnames()
        version = tar.extractfile("version.txt").read().decode()
    want = {"config.ini", "offline.pt2", "streaming_cell.pt2", "version.txt"}
    ckpts = sorted(os.listdir(os.path.join(_dir(family), "checkpoints")))
    assert set(names) == want | {f"checkpoints/{n}" for n in ckpts if n.startswith("model_")}
    assert version.startswith("deepfilternet_torch-")


@pytest.mark.parametrize("family", FAMILIES)
def test_programs_equal_eager(archives, family):
    model, _, _ = init_df(_dir(family), device="cpu")
    t_config.reset()
    x = [torch.from_numpy(a) for a in _inputs(model.cfg, 1)]
    (spec_e, m, lsnr, _), _ = model.module.forward(model.params, model.state, model.cfg, *x)
    got = t_export.load_exported(archives[family], "offline.pt2")(*x)
    for g, r in zip(got, (spec_e, m, lsnr)):
        assert _rel(g, r) <= EXACT
    cell = t_export.load_exported(archives[family], "streaming_cell.pt2")
    carry = ref_carry = model.module.streaming_init(1, model.cfg)
    for i in range(3):
        frame = [a[:, i] for a in x]
        carry, out = cell(carry, *frame)
        ref_carry, ref = model.module.streaming_cell(model.params, model.state, model.cfg,
                                                     ref_carry, *frame)
        assert type(carry) is type(ref_carry)
        for g, r in zip(list(carry) + list(out), list(ref_carry) + list(ref)):
            assert _rel(g, r) <= EXACT


def test_offline_program_matches_jax_stablehlo(archives, tmp_path):
    """The port's offline program and JAX's StableHLO one, each from its
    package's export of the DFN3 checkpoint, on the same inputs."""
    import jax.numpy as jnp

    from deepfilternet_tpu.scripts import export as j_export

    j_path = str(tmp_path / "jax.tar.gz")
    j_export.export_model(_dir("dfn3"), j_path)
    j_config.reset()
    ref = j_export.load_exported(j_path, "offline.stablehlo")
    model, _, _ = init_df(_dir("dfn3"), device="cpu")
    t_config.reset()
    x = _inputs(model.cfg, 2)
    got = t_export.load_exported(archives["dfn3"], "offline.pt2")(*map(torch.from_numpy, x))
    for g, r in zip(got, ref(*map(jnp.asarray, x))):
        assert _rel(g, r) <= TO_JAX


@pytest.mark.parametrize("family", ("dfn3",))
def test_skip_hlo_archive_read_by_both_packages(tmp_path, monkeypatch, family):
    from deepfilternet_tpu.enhance import init_df as j_init_df

    path = str(tmp_path / "model.tar.gz")
    t_export.export_model(_dir(family), path, skip_hlo=True, device="cpu")
    with tarfile.open(path, "r:gz") as tar:
        assert not any(n.endswith(".pt2") for n in tar.getnames())
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    model, _, suffix = init_df(path, device="cpu")
    t_config.reset()
    j_model, _, j_suffix = j_init_df(path)
    j_config.reset()
    assert suffix == j_suffix == f"e{model.epoch}"
    w = model.params["erb_conv0"]["w"].numpy()
    np.testing.assert_array_equal(w, np.asarray(j_model.params["erb_conv0"]["w"]))


def test_export_export_then_eager(archives):
    """Three exports and then eager use in one fresh process: each later
    export and the eager call find no tensor an earlier trace made (the
    archives' programs: `test_programs_equal_eager`)."""
    x, got = archives["eager"]
    model, df_state, _ = init_df(_dir(FAMILIES[0]), device="cpu")
    t_config.reset()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, enhance(model, df_state, x))


def test_mf_raises():
    model, df_state, _ = init_df(model_name="deepfilternetmf", device="cpu")
    t_config.reset()
    with pytest.raises(NotImplementedError, match="no streaming cell"):
        t_export.export_programs(model, df_state)
