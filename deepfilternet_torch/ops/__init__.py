from deepfilternet_torch.ops.erb import (  # noqa: F401
    erb2freq,
    erb_fb_matrices,
    erb_fb_tensor,
    erb_widths,
    freq2erb,
)
# `stft` the function is not re-exported: it would shadow the module
from deepfilternet_torch.ops.stft import (  # noqa: F401
    Stft,
    analysis_step_ri,
    dft_matrices,
    frame_signal,
    idft_matrices,
    istft,
    istft_ri,
    synthesis_step_ri,
    vorbis_window,
    wnorm,
)
from deepfilternet_torch.ops.norms import (  # noqa: F401
    MEAN_NORM_INIT,
    UNIT_NORM_INIT,
    erb_norm,
    erb_norm_step,
    get_norm_alpha,
    mean_norm_init,
    unit_norm,
    unit_norm_init,
)
from deepfilternet_torch.ops.features import (  # noqa: F401
    apply_interp_band_gain,
    erb_band_energies,
    erb_feat,
    spec_feat,
)
from deepfilternet_torch.ops.df_op import deep_filter, deep_filter_offline, spec_unfold  # noqa: F401
from deepfilternet_torch.ops.postfilter import post_filter  # noqa: F401
from deepfilternet_torch.ops.fused_frontend import (  # noqa: F401
    fused_analysis_frontend,
    fused_analysis_frontend_plain,
)
from deepfilternet_torch.ops.whole_cell import (  # noqa: F401
    CKEYS,
    WKEYS,
    CellStatics,
    build_cell_weights,
    cell_process,
    cell_process_plain,
)
