"""Explainers: Grad-CAM (the image and signal encoders and the fusion
model's image branch), gradient and Deep SHAP and LIME over the fused
embedding, TabNet masks, and the XAI batch CLI (`run_xai`)."""

from ecgmm_torch.explain.gradcam import (  # noqa: F401
    grad_cam_image,
    grad_cam_signal,
    overlay_heatmap,
)
from ecgmm_torch.explain.shap_fusion import (  # noqa: F401
    gradient_shap,
    modality_contributions,
)
from ecgmm_torch.explain.deep_shap import (  # noqa: F401
    deep_shap,
    explain_fusion_deep,
)
from ecgmm_torch.explain.lime_fusion import lime_tabular  # noqa: F401
from ecgmm_torch.explain.tabnet_masks import tabnet_masks  # noqa: F401
