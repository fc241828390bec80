"""The canonical trimodal model and its three encoders (PyTorch port of
`ecgmm_tpu/models`)."""

from ecgmm_torch.models.clinical import TabNetEncoder, sparsemax
from ecgmm_torch.models.fusion import ECGMultimodalModel, FusionOutput
from ecgmm_torch.models.resnet18 import ResNet18
from ecgmm_torch.models.resnet1d_se import ResNet1DSE

__all__ = [
    "ECGMultimodalModel", "FusionOutput", "ResNet18", "ResNet1DSE",
    "TabNetEncoder", "sparsemax",
]
