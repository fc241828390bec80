"""The canonical trimodal model, its three encoders, and the spectrogram
CRNN and 1-D Transformer signal classifiers (PyTorch port of
`ecgmm_tpu/models`)."""

from ecgmm_torch.models.clinical import TabNetEncoder, sparsemax
from ecgmm_torch.models.crnn import CRNN
from ecgmm_torch.models.fusion import ECGMultimodalModel, FusionOutput
from ecgmm_torch.models.resnet18 import ResNet18
from ecgmm_torch.models.resnet1d_se import ResNet1DSE
from ecgmm_torch.models.transformer1d import ECGTransformer1D

__all__ = [
    "CRNN", "ECGMultimodalModel", "ECGTransformer1D", "FusionOutput",
    "ResNet18", "ResNet1DSE", "TabNetEncoder", "sparsemax",
]
