"""The port's reference-checkpoint converters against the JAX package's.

State dicts with the reference DfNet's module names are built here from
JAX-initialised parameters (as `tests/test_convert.py` builds DFN3's, no
reference checkout needed): DFN3 (index-keyed Conv2dNormAct sequences,
SqueezedGRU_S), DFN2 with either `gru_type` (SqueezedGRU; GroupedGRU and
GroupedLinear at 4 groups), DFN1 (name-keyed convkxf blocks, at widths where
convkxf's group rule and the gcd rule disagree). For each:

  * both packages' converters give equal trees, and the tree reproduces the
    source parameters;
  * the port's `forward` on the converted tree equals JAX's on the source
    tree, 1e-4;
  * `load_torch_checkpoint` on a `torch.save`d file gives JAX's dict.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from _torch_families import SMALL, both_configs, check_forward, rand_inputs  # noqa: E402
from deepfilternet_tpu import checkpoint as j_ckpt  # noqa: E402
from deepfilternet_tpu.models import dfnet1 as j_dfnet1  # noqa: E402
from deepfilternet_tpu.models import dfnet2 as j_dfnet2  # noqa: E402
from deepfilternet_tpu.models import dfnet3 as j_dfnet3  # noqa: E402
from deepfilternet_torch import checkpoint as t_ckpt  # noqa: E402
from deepfilternet_torch.checkpoint import params_from_numpy  # noqa: E402
from deepfilternet_torch.config import config as t_config  # noqa: E402
from deepfilternet_torch.models import dfnet1 as t_dfnet1  # noqa: E402
from deepfilternet_torch.models import dfnet2 as t_dfnet2  # noqa: E402
from deepfilternet_torch.models import dfnet3 as t_dfnet3  # noqa: E402

D = "deepfilternet"


@pytest.fixture(scope="module", autouse=True)
def _fresh_port_config():
    """Reset the port's global config; run torch on one CPU thread (the
    suite runs several workers at once)."""
    t_config.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    t_config.reset()


def _a(x):
    return np.asarray(x)


# -- reference-named tensors of each block kind --------------------------------------


def _seq_conv(p, s, theirs):
    """A Conv2dNormAct sequence: [pad] -> conv -> [pointwise] -> [batch norm],
    keyed by index."""
    sd = {}
    idx = 1 if p["w"].shape[-2] > 1 else 0  # a time kernel above 1: the pad comes first
    sd[f"{theirs}.{idx}.weight"] = _a(p["w"])
    if "b" in p:
        sd[f"{theirs}.{idx}.bias"] = _a(p["b"])
    idx += 1
    if "pw" in p:
        sd[f"{theirs}.{idx}.weight"] = _a(p["pw"])
        idx += 1
    if "bn" in p:
        sd.update(_bn(p, s, f"{theirs}.{idx}"))
    return sd


def _kxf_conv(p, s, theirs):
    """A convkxf block: sconv (or sconvt), pconv, norm, keyed by name."""
    sd = {f"{theirs}.sconv.weight": _a(p["w"])}
    if "b" in p:
        sd[f"{theirs}.sconv.bias"] = _a(p["b"])
    if "pw" in p:
        sd[f"{theirs}.pconv.weight"] = _a(p["pw"])
    if "bn" in p:
        sd.update(_bn(p, s, f"{theirs}.norm"))
    return sd


def _bn(p, s, base):
    return {f"{base}.weight": _a(p["bn"]["scale"]), f"{base}.bias": _a(p["bn"]["bias"]),
            f"{base}.running_mean": _a(s["bn"]["mean"]), f"{base}.running_var": _a(s["bn"]["var"]),
            f"{base}.num_batches_tracked": np.asarray(0)}


def _gru(p, theirs):
    sd = {}
    for li, lp in enumerate(p["layers"]):
        for ours, ref in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                          ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"{theirs}.{ref}_l{li}"] = _a(lp[ours])
    return sd


def _sgru(p, theirs):
    sd = {f"{theirs}.linear_in.0.weight": _a(p["linear_in"]["w"])}
    sd.update(_gru(p["gru"], f"{theirs}.gru"))
    if "linear_out" in p:
        sd[f"{theirs}.linear_out.0.weight"] = _a(p["linear_out"]["w"])
    if "skip" in p:
        sd[f"{theirs}.gru_skip.weight"] = _a(p["skip"]["w"])
    return sd


def _linear(p, theirs):
    sd = {f"{theirs}.weight": _a(p["w"])}
    if "b" in p:
        sd[f"{theirs}.bias"] = _a(p["b"])
    return sd


def _glinear(p, theirs):
    sd = {}
    for i, lp in enumerate(p["layers"]):
        sd.update(_linear(lp, f"{theirs}.layers.{i}"))
    return sd


def _ggru(p, theirs):
    sd = {}
    for li, layer in enumerate(p["layers"]):
        for gi, gp in enumerate(layer):
            sd.update(_gru(gp, f"{theirs}.grus.{li}.layers.{gi}"))
    return sd


BUFFERS = {"erb_fb": np.zeros((481, 32), np.float32),
           "mask.erb_inv_fb": np.zeros((32, 481), np.float32)}


def _sd_dfn3(p, s):
    sd = dict(BUFFERS)
    for ours, theirs in j_ckpt._DFN3_CONV_MAP.items():
        sd.update(_seq_conv(p[ours], s.get(ours, {}), theirs))
    for ours, theirs in j_ckpt._DFN3_GRU_MAP.items():
        sd.update(_sgru(p[ours], theirs))
    sd["enc.df_fc_emb.0.weight"] = _a(p["df_fc_emb"]["w"])
    sd.update(_linear(p["lsnr_fc"], "enc.lsnr_fc.0"))
    sd["df_dec.df_out.0.weight"] = _a(p["df_out"]["w"])
    sd.update(_linear(p["df_fc_a"], "df_dec.df_fc_a.0"))
    return sd


def _sd_dfn2(p, s):
    sd = dict(BUFFERS)
    for ours, theirs in j_ckpt._DFN2_CONV_MAP.items():
        sd.update(_seq_conv(p[ours], s.get(ours, {}), theirs))
    if "layers" in p["enc_emb_gru"]:  # grouped
        sd.update(_glinear(p["df_fc_emb"], "enc.df_fc_emb"))
        sd.update(_ggru(p["enc_emb_gru"], "enc.emb_gru"))
        sd.update(_ggru(p["dec_emb_gru"], "erb_dec.emb_gru"))
        sd.update(_glinear(p["dec_fc_emb"], "erb_dec.fc_emb.0"))
        sd.update(_ggru(p["df_gru"], "df_dec.df_gru"))
    else:
        sd["enc.df_fc_emb.0.weight"] = _a(p["df_fc_emb"]["w"])
        for ours, theirs in j_ckpt._DFN3_GRU_MAP.items():
            sd.update(_sgru(p[ours], theirs))
    sd.update(_linear(p["lsnr_fc"], "enc.lsnr_fc.0"))
    sd.update(_linear(p["df_out"], "df_dec.df_out.0"))
    sd.update(_linear(p["df_fc_a"], "df_dec.df_fc_a.0"))
    return sd


def _sd_dfn1(p, s):
    sd = dict(BUFFERS)
    for ours, theirs in j_ckpt._DFN1_CONV_MAP.items():
        sd.update(_kxf_conv(p[ours], s.get(ours, {}), theirs))
    sd.update(_glinear(p["df_fc_emb"], "enc.df_fc_emb"))
    sd.update(_ggru(p["enc_emb_gru"], "enc.emb_gru"))
    sd.update(_linear(p["lsnr_fc"], "enc.lsnr_fc.0"))
    sd.update(_glinear(p["dec_fc_emb"], "erb_dec.fc_emb.0"))
    sd.update(_ggru(p["df_gru"], "df_dec.df_gru"))
    sd.update(_linear(p["df_out"], "df_dec.df_fc_out.0"))
    sd.update(_linear(p["df_fc_a"], "df_dec.df_fc_a.0"))
    return sd


def _keys(**extra):
    keys = dict(SMALL)
    keys.update({(k, "DF" if k == "DF_ORDER" else D): v for k, v in extra.items()})
    return keys


# family: (JAX module, port module, state-dict maker, converter name, config keys)
CASES = {
    "dfn3": (j_dfnet3, t_dfnet3, _sd_dfn3, "convert_dfn3_state_dict", _keys()),
    "dfn2_squeeze": (j_dfnet2, t_dfnet2, _sd_dfn2, "convert_dfn2_state_dict",
                     _keys(GRU_TYPE="squeeze", DF_OUTPUT_LAYER="groupedlinear",
                           DFOP_METHOD="complex_strided", DF_N_ITER="1")),
    "dfn2_grouped": (j_dfnet2, t_dfnet2, _sd_dfn2, "convert_dfn2_state_dict",
                     _keys(GRU_TYPE="grouped", GRU_GROUPS="4", LINEAR_GROUPS="4")),
    "dfn1": (j_dfnet1, t_dfnet1, _sd_dfn1, "convert_dfn1_state_dict",
             _keys(CONV_CH="12", DF_ORDER="4", GRU_GROUPS="4", LINEAR_GROUPS="4")),
}


def _init(j_mod, t_mod, keys):
    """JAX's random params of the family, and both packages' configs."""
    name = j_mod.__name__.rsplit(".", 1)[1].replace("dfnet", "init_dfnet")
    with both_configs(keys):
        jp, js, jcfg = getattr(j_mod, name)(jax.random.PRNGKey(3))
        _, _, tcfg = getattr(t_mod, name)(torch.Generator().manual_seed(0))
    return jp, js, jcfg, tcfg


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_converters_match_jax(case):
    j_mod, t_mod, make_sd, conv_name, keys = CASES[case]
    jp, js, jcfg, tcfg = _init(j_mod, t_mod, keys)
    sd = make_sd(jp, js)
    tp, ts = getattr(t_ckpt, conv_name)(sd)
    rp, rs = getattr(j_ckpt, conv_name)(sd)
    for got, ref, src in ((tp, rp, jp), (ts, rs, js)):
        assert all(isinstance(v, np.ndarray) for v in jax.tree_util.tree_leaves(got))
        g, r, o = _flat(got), _flat(ref), _flat(src)
        assert g.keys() == r.keys() == o.keys()
        for k in g:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            np.testing.assert_array_equal(g[k], o[k], err_msg=k)
    # the port's forward on the converted tree, JAX's on the source tree
    tp, ts = params_from_numpy(tp, ts, "cpu")
    inputs = rand_inputs(4, 1, 6, jcfg)
    if case == "dfn3":
        names = ("spec_e", "mask", "lsnr", "df_coefs")
    else:
        names = ("spec_e", "mask", "lsnr", "alpha")
    check_forward(j_mod, t_mod, (jp, js, jcfg, tp, ts, tcfg), inputs, names=names)


def test_convert_dfn1_group_count_comes_from_the_config():
    """At 12 conv channels and order 4 the DF pathway conv (12 -> 8, complex)
    has 1 group by convkxf's rule and would have 2 by the gcd rule: the
    converted weight fits the port's config only with the former."""
    jp, js, jcfg, tcfg = _init(j_dfnet1, t_dfnet1, CASES["dfn1"][4])
    tp, _ = t_ckpt.convert_dfn1_state_dict(_sd_dfn1(jp, js))
    assert tcfg["layers"]["df_convp"]["groups"] == 1
    assert tp["df_convp"]["w"].shape == (8, 12, 1, 1) and "pw" not in tp["df_convp"]


def test_conv_block_rejects_what_it_cannot_tell_apart():
    w = np.zeros((4, 4, 3, 3), np.float32)
    with pytest.raises(KeyError):
        t_ckpt._convert_conv_block({"a.0.weight": w}, "b")
    with pytest.raises(ValueError):
        t_ckpt._convert_conv_block({"a.0.weight": w, "a.1.weight": w}, "a")


def test_load_torch_checkpoint(tmp_path):
    jp, js, _, _ = _init(j_dfnet2, t_dfnet2, CASES["dfn2_grouped"][4])
    sd = _sd_dfn2(jp, js)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    for name, obj in (("plain.ckpt", tensors),
                      ("wrapped.ckpt", {"state_dict": tensors, "epoch": 3})):
        path = str(tmp_path / name)
        torch.save(obj, path)
        got, ref = t_ckpt.load_torch_checkpoint(path), j_ckpt.load_torch_checkpoint(path)
        assert got.keys() == ref.keys() == sd.keys()
        for k in got:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # and through the converter, as a user loads a reference checkpoint
    tp, _ = t_ckpt.convert_dfn2_state_dict(t_ckpt.load_torch_checkpoint(path))
    np.testing.assert_array_equal(tp["df_gru"]["layers"][1][3]["layers"][0]["w_hh"],
                                  _a(jp["df_gru"]["layers"][1][3]["layers"][0]["w_hh"]))
