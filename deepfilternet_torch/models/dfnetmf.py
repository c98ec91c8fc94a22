"""DeepFilterNet-MF: the DFN3 backbone with a multi-frame WF or MVDR output.

The DF coefficient decoder gives way to two heads: the speech inter-frame
correlation vector (ifc, [B, T, F', O*2]) and a covariance matrix (cov,
[B, T, F', O^2*2]), the noisy covariance for the Wiener filter and the noise
covariance for MVDR, which `models.multiframe.mf_wf` / `mf_mvdr` consume.
Offline only, as in the JAX package and the reference: the family has no
streaming form.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deepfilternet_torch.config import config
from deepfilternet_torch.models import dfnet3
from deepfilternet_torch.models.dfnet3 import ModelParams3, _tree_to
from deepfilternet_torch.models.multiframe import mf_mvdr, mf_wf
from deepfilternet_torch.nn import (
    grouped_linear_apply,
    init_conv2d_norm_act,
    init_grouped_linear,
    squeezed_gru_s_apply,
)


class ModelParamsMF(ModelParams3):
    def __init__(self):
        super().__init__()
        s = self.section
        self.mfop_method: str = str(config("MFOP_METHOD", cast=str, default="WF", section=s)).upper()
        self.mf_est_inverse: bool = config("MF_ESTIMATE_INVERSE", cast=bool, default=True,
                                           section=s)
        self.mf_use_cholesky_decomp: bool = config("MF_USE_CHOLESKY_DECOMP", cast=bool,
                                                   default=False, section=s)


def init_dfnetmf(generator: torch.Generator, p: Optional[ModelParamsMF] = None,
                 device="cpu") -> Tuple[Dict, Dict, Dict]:
    """Random parameters from `generator`; the tree layout and cfg equal the
    JAX package's `init_dfnetmf`."""
    p = p or ModelParamsMF()
    params, state, cfg = dfnet3.init_dfnet3(generator, p)
    # the DF coefficient head gives way to the ifc and cov heads
    L = cfg["layers"]
    for name in ("df_out", "df_fc_a", "df_convp"):
        params.pop(name, None)
        state.pop(name, None)
    L.pop("df_convp", None)
    ch, kt, o = cfg["conv_ch"], cfg["df_pathway_kt"], cfg["df_order"]
    for name, width in (("ifc_convp", o * 2), ("cov_convp", o * o * 2)):
        params[name], st, L[name] = init_conv2d_norm_act(generator, ch, width, (kt, 1),
                                                         bias=False, separable=True)
        if st:
            state[name] = st
    lin_groups = config("LINEAR_GROUPS", 1, int, section="deepfilternet")
    params["ifc_out"] = init_grouped_linear(generator, cfg["df_hidden_dim"],
                                            cfg["nb_df"] * o * 2, groups=lin_groups)
    params["cov_out"] = init_grouped_linear(generator, cfg["df_hidden_dim"],
                                            cfg["nb_df"] * o * o * 2, groups=lin_groups)
    cfg = dict(cfg, generation="mf", mfop_method=p.mfop_method,
               mf_est_inverse=p.mf_est_inverse, mf_use_cholesky_decomp=p.mf_use_cholesky_decomp)
    return _tree_to(params, device), _tree_to(state, device), cfg


def forward(params: Dict, state: Dict, cfg: Dict, spec: torch.Tensor,
            feat_erb: torch.Tensor, feat_spec: torch.Tensor, train: bool = False):
    """Offline forward, `train=True` for training (dfnet3.forward's
    batchnorm statistics; no LSNR dropout, as JAX's). The I/O of
    dfnet3.forward, with (ifc, cov) as the 4th output."""
    L = cfg["layers"]
    new_state = dict(state)
    conv = dfnet3._seq_conv(params, state, L, train, new_state)
    e0, e1, e2, e3, emb, c0, lsnr = dfnet3._encoder(
        params, conv, L, cfg, feat_erb[:, None], torch.movedim(feat_spec, -1, 1))
    mask = dfnet3._erb_decoder(params, conv, L, cfg, emb, e3, e2, e1, e0)  # [B, T, E]
    spec_c = torch.complex(spec[..., 0], spec[..., 1])
    spec_m = spec_c * (mask @ dfnet3._inv_fb(cfg, mask.device))

    b, t, _ = emb.shape
    o, nb_df = cfg["df_order"], cfg["nb_df"]
    c, _ = squeezed_gru_s_apply(params["df_gru"], L["df_gru"], emb)
    c = dfnet3._df_skip(params, cfg, c, emb)

    def head(name, width):
        lin = grouped_linear_apply(params[f"{name}_out"], c).reshape(b, t, nb_df, width)
        return lin + conv(f"{name}_convp", c0).permute(0, 2, 3, 1)  # [B, T, F', width]

    ifc, cov = head("ifc", o * 2), head("cov", o * o * 2)
    ifc_r = ifc.reshape(b, t, nb_df, o, 2)
    cov_r = cov.reshape(b, t, nb_df, o, o, 2)
    if cfg.get("run_df", True):
        mf = mf_wf if cfg["mfop_method"] == "WF" else mf_mvdr
        spec_e = mf(spec_c, torch.complex(ifc_r[..., 0], ifc_r[..., 1]),
                    torch.complex(cov_r[..., 0], cov_r[..., 1]), nb_df, o, cfg["df_lookahead"],
                    cholesky_decomp=cfg["mf_use_cholesky_decomp"], inverse=cfg["mf_est_inverse"])
        spec_e = torch.cat([spec_e[..., :nb_df], spec_m[..., nb_df:]], dim=-1)
    else:
        spec_e = spec_m  # mask-only ablation: the multi-frame filter is skipped
    spec_e_ri = torch.stack([spec_e.real, spec_e.imag], dim=-1)
    return (spec_e_ri, mask, lsnr, (ifc, cov)), new_state
