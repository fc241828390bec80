"""Serving pipeline: digitize -> infer -> explain -> report (port of
`ecgmm_tpu/serve/pipeline.py`, the single-request path).

`ServingPipeline.predict` answers one request of the mobile app's
contract (`Groove/app/(tabs)/ResultScreen.tsx:26-56`). Its device work,
`_predict_all`, is the JAX request program written out in PyTorch:
  1. encode the three modalities once, without autograd;
  2. Grad-CAM: the image-branch logit's gradient w.r.t. the layer-4 map;
  3. SHAP: expected gradients of the fusion logit over the fused
     embedding, 32 draws in one batch through `fuse_embeddings`;
  4. clinical IG: 8-step midpoint integrated gradients over the raw
     clinical inputs, as one 8-row batch that reuses the image and signal
     embeddings (every module is in eval mode and rows are independent).
The outputs are packed into one tensor and read back to the host once.

Micro-batching, mesh serving, AOT bundles and the HTTP front end are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.explain.gradcam import cam_from_image_map
from ecgmm_torch.explain.shap_fusion import draw_shap_samples, gradient_shap
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.serve import request as request_host

SHAP_SAMPLES = 32
IG_STEPS = 8


class ServingPipeline:
    """The fusion model on `device` plus the scaler context; stateless per
    request.

    shap_draws: (bidx, alphas), each (32,), fixes SHAP's background
    indices and interpolation points (the tests pass the JAX draws). By
    default they are drawn once from a generator seeded 0, so, as in the
    JAX pipeline, every request uses the same draws."""

    def __init__(
        self,
        model: ECGMultimodalModel,
        state_dict: Dict[str, torch.Tensor],
        ecg_scaler=None,
        clinical_scaler=None,
        background_embeddings: Optional[np.ndarray] = None,
        signal_len: int = 2476,
        img_hw: Tuple[int, int] = (224, 224),
        temperature: float = 1.0,
        device: str = "cuda",
        shap_draws=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingPipeline: device 'cuda' requested but no CUDA device "
                "is available; pass device='cpu' to serve on the CPU"
            )
        self.temperature = float(temperature)
        if not (np.isfinite(self.temperature) and self.temperature > 0):
            raise ValueError(
                f"temperature must be a positive finite scalar, got "
                f"{temperature!r}"
            )
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        for p in self.model.parameters():
            p.requires_grad_(False)
        self.ecg_scaler = ecg_scaler
        self.clinical_scaler = clinical_scaler
        self.signal_len = signal_len
        self.img_hw = tuple(img_hw)
        cfg = model.cfg
        self.dims = (cfg.image_dim, cfg.signal_dim, cfg.clinical_dim)
        self.n_clin = cfg.clinical_in_features
        if background_embeddings is None:
            rng = np.random.default_rng(0)
            background_embeddings = rng.normal(
                size=(32, sum(self.dims))
            ).astype(np.float32)
        self.background = torch.as_tensor(
            np.asarray(background_embeddings, np.float32), device=self.device
        )
        if shap_draws is None:
            shap_draws = draw_shap_samples(
                1, SHAP_SAMPLES, self.background.shape[0],
                torch.Generator().manual_seed(0),
            )
        bidx, alphas = shap_draws
        self.shap_bidx = torch.as_tensor(
            np.array(bidx, np.int64).reshape(1, SHAP_SAMPLES),
            device=self.device)
        self.shap_alphas = torch.as_tensor(
            np.array(alphas, np.float32).reshape(1, SHAP_SAMPLES),
            device=self.device)
        self.ig_alphas = (
            torch.arange(IG_STEPS, dtype=torch.float32, device=self.device)
            + 0.5
        ) / IG_STEPS
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._latency_sum = 0.0
        # host-before / device / host-after split of the last request, ms
        self.last_timing: Dict[str, float] = {}

    @classmethod
    def demo(cls, device: str = "cuda", seed: int = 0) -> "ServingPipeline":
        """Self-contained demo with seeded random weights — see
        loaders.demo_pipeline."""
        from ecgmm_torch.serve.loaders import demo_pipeline

        return demo_pipeline(cls, device=device, seed=seed)

    def _predict_all(self, img, sig, clin):
        """The request's device work; returns one packed f32 vector:
        probs (C), pred (1), cam (h*w), attr (D), clinical IG (F)."""
        m = self.model
        d0, d1, _ = self.dims
        with torch.no_grad():
            img_f, sig_f, clin_f, _, img_map = m.encode(
                img, sig, clin, return_image_map=True
            )
            logits = m.fuse_embeddings(img_f, sig_f, clin_f)
            # temperature never moves argmax, only the probability
            probs = torch.softmax(logits * (1.0 / self.temperature), dim=-1)
            pred = probs[0].argmax()
        cam, _ = cam_from_image_map(m, img_map, pred)
        emb = torch.cat([img_f, sig_f, clin_f], dim=1)
        attr = gradient_shap(
            lambda e: m.fuse_embeddings(e[:, :d0], e[:, d0:d0 + d1],
                                        e[:, d0 + d1:]),
            emb, self.background, pred, n_samples=SHAP_SAMPLES,
            bidx=self.shap_bidx, alphas=self.shap_alphas,
        )
        ca = self._clinical_ig(img_f, sig_f, clin, pred)
        return torch.cat([
            probs.reshape(-1), pred.reshape(1).float(), cam.reshape(-1),
            attr.reshape(-1), ca.reshape(-1),
        ])

    def _clinical_ig(self, img_f, sig_f, clin, cls):
        """Per-dimension attribution over the raw clinical inputs:
        integrated gradients of the predicted-class fusion logit from the
        scaled cohort mean (zeros) to the request's vector, midpoint rule,
        IG_STEPS steps, all steps as one batch."""
        m = self.model
        n = IG_STEPS
        with torch.enable_grad():
            path = (self.ig_alphas[:, None] * clin).requires_grad_(True)
            clin_f, _ = m.encode_clinical(path)
            logits = m.fuse_embeddings(img_f.expand(n, -1),
                                       sig_f.expand(n, -1), clin_f)
            (grads,) = torch.autograd.grad(logits[:, cls].sum(), path)
        return clin[0] * grads.mean(dim=0)

    def _unpack(self, flat: np.ndarray, cam_hw: Tuple[int, int]):
        c, d, f = self.model.cfg.num_classes, sum(self.dims), self.n_clin
        sizes = [c, 1, cam_hw[0] * cam_hw[1], d, f]
        probs, pred, cam, attr, ca = np.split(flat, np.cumsum(sizes)[:-1])
        return (probs, int(round(float(pred[0]))),
                cam.reshape((1,) + cam_hw), attr.reshape(1, d), ca)

    def predict(self, image_u8: np.ndarray, questionnaire: Dict,
                heatmap_format: str = "png") -> Dict:
        """One request: an RGB uint8 strip photo and the questionnaire ->
        the ResultScreen response. heatmap_format "png" returns the
        base64 PNG overlay; "cam" returns the raw low-resolution CAM
        under heatmap_cam and an empty heatmap."""
        t0 = time.perf_counter()
        request_host.check_heatmap_format(heatmap_format)
        (img_norm, sig, clin, mv, dig_info, age, image_u8
         ) = request_host.prepare_inputs(self, image_u8, questionnaire)
        dev = self.device
        img = torch.from_numpy(img_norm).permute(0, 3, 1, 2).contiguous()
        img, sig_t, clin_t = (torch.as_tensor(a).to(dev) for a in
                              (img, sig, clin))
        # every stride-2 stage of ResNet18 maps n to ceil(n / 2)
        cam_hw = (-(-self.img_hw[0] // 32), -(-self.img_hw[1] // 32))
        t1 = time.perf_counter()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            packed = self._predict_all(img, sig_t, clin_t)
            end.record()
            flat = packed.cpu().numpy()  # the one readback; synchronises
            device_ms = start.elapsed_time(end)
        else:
            flat = self._predict_all(img, sig_t, clin_t).numpy()
            device_ms = (time.perf_counter() - t1) * 1e3
        t2 = time.perf_counter()
        probs, pred, cam, attr, ca = self._unpack(flat, cam_hw)
        resp = request_host.assemble_response(
            self, mv=mv, dig_info=dig_info, image_u8=image_u8,
            questionnaire=questionnaire, probs=probs, pred=pred,
            cam=cam, attr=attr, ca_a=ca, age=age,
            heatmap_format=heatmap_format,
        )
        t3 = time.perf_counter()
        self.last_timing = {
            "host_before_ms": (t1 - t0) * 1e3,
            "device_ms": device_ms,
            "host_after_ms": (t3 - t2) * 1e3,
            "total_ms": (t3 - t0) * 1e3,
        }
        with self._stats_lock:
            self._n_requests += 1
            self._latency_sum += t3 - t0
        return resp

    def stats(self) -> Dict:
        """Operational counters."""
        with self._stats_lock:
            n, lat = self._n_requests, self._latency_sum
        return {
            "requests": n,
            "mean_latency_ms": (lat / n * 1e3) if n else 0.0,
            "temperature": self.temperature,
            "device": str(self.device),
        }
