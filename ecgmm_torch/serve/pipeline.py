"""Serving pipeline: digitize -> infer -> explain -> report (port of
`ecgmm_tpu/serve/pipeline.py`).

`ServingPipeline.predict` answers one request of the mobile app's
contract (`Groove/app/(tabs)/ResultScreen.tsx:26-56`). Its device work,
`_predict_many`, is the JAX request program written out in PyTorch over a
bucket of b requests at once (JAX vmaps the single-request program over
the bucket; every module here is in eval mode, so rows are independent):
  1. encode the three modalities once, without autograd;
  2. Grad-CAM: each row's image-branch logit of its own predicted class,
     differentiated w.r.t. the layer-4 map;
  3. SHAP: expected gradients of each row's fusion logit over its fused
     embedding, the same 32 draws for every row, all 32*b points in one
     pass through `fuse_embeddings`;
  4. clinical IG: 8-step midpoint integrated gradients over each row's
     raw clinical inputs, all 8*b points in one pass that reuses the
     image and signal embeddings.
Each row's outputs are packed into one f32 row, and a dispatch reads its
(b, K) rows back to the host once. A request alone is a bucket of one.

The device program runs under the pipeline's device lock and with TF32
off (`precision.no_tf32`), so float32 work is float32 whatever the
process's flags. With `enable_batching` concurrent `predict` calls
coalesce into bucketed dispatches on the micro-batcher's one worker
thread (`serve/batching.py`). The HTTP front end is `serve/http.py`; the
assembly recipes are in `serve/loaders.py`.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ecgmm_torch.explain.gradcam import cam_from_image_map
from ecgmm_torch.explain.shap_fusion import draw_shap_samples, gradient_shap
from ecgmm_torch.models import ECGMultimodalModel
from ecgmm_torch.parallel import mesh as meshlib
from ecgmm_torch.precision import no_tf32
from ecgmm_torch.serve import batching
from ecgmm_torch.serve import request as request_host

SHAP_SAMPLES = 32
IG_STEPS = 8
# /metrics latency-histogram bucket upper bounds, in seconds (the JAX
# package's series)
LATENCY_BUCKETS = (0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4,
                   float("inf"))


def _rss_bytes() -> int:
    """Resident set size from /proc (no psutil needed)."""
    import os

    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b name one device (a CUDA device without an index is
    the current one)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


class ServingPipeline:
    """The fusion model on `device` plus the scaler context; stateless per
    request.

    shap_draws: (bidx, alphas), each (32,), fixes SHAP's background
    indices and interpolation points (the tests pass the JAX draws). By
    default they are drawn once from a generator seeded 0, so, as in the
    JAX pipeline, every request, and every row of a bucket, uses the same
    draws."""

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
        # every stride-2 stage of ResNet18 maps n to ceil(n / 2)
        self.cam_hw = (-(-self.img_hw[0] // 32), -(-self.img_hw[1] // 32))
        cfg = model.cfg
        self.dims = (cfg.image_dim, cfg.signal_dim, cfg.clinical_dim)
        self.n_clin = cfg.clinical_in_features
        self.num_classes = cfg.num_classes
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
        self._exported_buckets = None
        self._init_serving_state()

    def _init_serving_state(self) -> None:
        """The locks, counters and batching state of a new pipeline, live
        or loaded from a bundle."""
        # one device program at a time: CUDA events of a dispatch then
        # time that dispatch alone
        self._device_lock = threading.RLock()
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._latency_sum = 0.0
        self._n_errors = 0
        # per-bucket (non-cumulative) counts; metrics() cumulates them
        self._latency_hist = [0] * len(LATENCY_BUCKETS)
        self._batcher: Optional[batching.MicroBatcher] = None
        self._serve_n_data = 1
        # mesh serving's batch functions (and their replicas) by n_data
        self._mesh_fns: Dict[int, object] = {}
        # called after every served prediction (the --max-requests recycle
        # of serve/http.py)
        self.on_request_done = None
        # host-before / device / host-after split of the last request, ms
        self.last_timing: Dict[str, float] = {}

    # -- constructors (assembly recipes live in serve/loaders.py) --------

    @classmethod
    def demo(cls, device: str = "cuda", seed: int = 0) -> "ServingPipeline":
        """Self-contained demo with seeded random weights — see
        loaders.demo_pipeline."""
        from ecgmm_torch.serve.loaders import demo_pipeline

        return demo_pipeline(cls, device=device, seed=seed)

    @classmethod
    def from_run(cls, run_dir: str, data, model=None, which: str = "best",
                 device: str = "cuda") -> "ServingPipeline":
        """A trained run's checkpoint — see loaders.pipeline_from_run."""
        from ecgmm_torch.serve.loaders import pipeline_from_run

        return pipeline_from_run(cls, run_dir, data, model=model,
                                 which=which, device=device)

    @classmethod
    def from_exported(cls, bundle_dir: str,
                      device: str = "cuda") -> "ServingPipeline":
        """An AOT bundle's programs for `device` (serve/export.py), with no
        model — see loaders.pipeline_from_exported."""
        from ecgmm_torch.serve.loaders import pipeline_from_exported

        return pipeline_from_exported(cls, bundle_dir, device=device)

    # -- the device program ----------------------------------------------

    def _predict_many(self, img, sig, clin):
        """The request program over a bucket of b rows: img (b, 3, H, W),
        sig (b, T), clin (b, F) on the pipeline's device. Returns (b, K)
        f32 rows, each packing that row's probs (C), pred (1), cam (h*w),
        SHAP attribution (D) and clinical IG (F)."""
        m = self.model
        b = img.shape[0]
        d0, d1, _ = self.dims
        with self._device_lock, no_tf32():
            with torch.no_grad():
                img_f, sig_f, clin_f, _, img_map = m.encode(
                    img, sig, clin, return_image_map=True
                )
                logits = m.fuse_embeddings(img_f, sig_f, clin_f)
                # temperature never moves argmax, only the probability
                probs = torch.softmax(logits * (1.0 / self.temperature),
                                      dim=-1)
                pred = probs.argmax(dim=-1)
            cam, _ = cam_from_image_map(m, img_map, pred)
            emb = torch.cat([img_f, sig_f, clin_f], dim=1)
            attr = gradient_shap(
                lambda e: m.fuse_embeddings(e[:, :d0], e[:, d0:d0 + d1],
                                            e[:, d0 + d1:]),
                emb, self.background, pred, n_samples=SHAP_SAMPLES,
                bidx=self.shap_bidx.expand(b, -1),
                alphas=self.shap_alphas.expand(b, -1),
            )
            ca = self._clinical_ig_many(img_f, sig_f, clin, pred)
            return torch.cat([
                probs, pred[:, None].float(), cam.reshape(b, -1), attr, ca,
            ], dim=1)

    def _clinical_ig_many(self, img_f, sig_f, clin, cls):
        """Per-dimension attribution over each row's raw clinical inputs
        (b, F): integrated gradients of the row's class (cls (b,)) fusion
        logit from the scaled cohort mean (zeros) to its vector, midpoint
        rule, IG_STEPS steps, all rows' steps as one batch."""
        m = self.model
        n = IG_STEPS
        b = clin.shape[0]
        with torch.enable_grad():
            path = (self.ig_alphas[None, :, None] * clin[:, None, :]
                    ).reshape(b * n, -1).requires_grad_(True)
            clin_f, _ = m.encode_clinical(path)
            logits = m.fuse_embeddings(img_f.repeat_interleave(n, dim=0),
                                       sig_f.repeat_interleave(n, dim=0),
                                       clin_f)
            rows = torch.arange(b * n, device=clin.device)
            score = logits[rows, cls.repeat_interleave(n)].sum()
            (grads,) = torch.autograd.grad(score, path)
        return clin * grads.reshape(b, n, -1).mean(dim=1)

    def _dispatch(self, img: np.ndarray, sig: np.ndarray, clin: np.ndarray):
        """Host arrays of a bucket -> ((b, K) packed rows on the host, the
        device program's ms). The rows cross back in one readback; on the
        card CUDA events time the program."""
        dev = self.device
        ins = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
               for a in (img, sig, clin)]
        with self._device_lock:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                packed = self._predict_many(*ins)
                end.record()
                rows = packed.cpu().numpy()  # the readback; synchronises
                return rows, start.elapsed_time(end)
            t = time.perf_counter()
            rows = self._predict_many(*ins).numpy()
            return rows, (time.perf_counter() - t) * 1e3

    def _batch_fn(self, img, sig, clin):
        """The micro-batcher's device function: per row, its packed
        outputs and its dispatch's device ms."""
        rows, ms = self._dispatch(img, sig, clin)
        return rows, np.full(rows.shape[0], ms)

    def _unpack(self, row: np.ndarray):
        c, d, f = self.num_classes, sum(self.dims), self.n_clin
        h, w = self.cam_hw
        sizes = [c, 1, h * w, d, f]
        probs, pred, cam, attr, ca = np.split(row, np.cumsum(sizes)[:-1])
        return (probs, int(round(float(pred[0]))),
                cam.reshape(1, h, w), attr.reshape(1, d), ca)

    def _load_exported_batched(self) -> None:
        """Load the bundle's batched programs once (deferred from
        `from_exported`: each carries its own copy of the weights)."""
        if not set(self._exported_buckets) <= set(self._programs):
            from ecgmm_torch.serve.export import load_batched_programs

            self._programs.update(
                load_batched_programs(self._bundle_dir, self.device))

    # -- micro-batching ----------------------------------------------------

    def _replica(self, device: torch.device) -> "ServingPipeline":
        """A copy of this pipeline whose model and device tensors lie on
        `device`, with a lock of its own (the counters stay this
        pipeline's)."""
        rep = copy.copy(self)
        rep.device = device
        rep.model = copy.deepcopy(self.model).to(device)
        for name in ("background", "shap_bidx", "shap_alphas", "ig_alphas"):
            setattr(rep, name, getattr(self, name).to(device))
        rep._device_lock = threading.RLock()
        return rep

    def _mesh_batch_fn(self, n_data: int):
        """The micro-batcher's device function of mesh serving over the
        first n_data visible devices, built once per n_data: each bucketed
        dispatch splits into n_data equal row slices, one per replica, run
        concurrently (a thread each, on its device's current stream) and
        concatenated; a row's device ms is its dispatch's slowest slice.
        This pipeline is the replica on its own device; the others are
        copies."""
        fn = self._mesh_fns.get(n_data)
        if fn is not None:
            return fn
        devices = meshlib.visible_devices(self.device)[:n_data]
        own = _same_device(devices[0], self.device)
        replicas = [self if i == 0 and own else self._replica(d)
                    for i, d in enumerate(devices)]

        def run_slices(img, sig, clin):
            k = img.shape[0] // n_data
            out: list = [None] * n_data

            def work(i):
                rep = replicas[i]
                rows = slice(i * k, (i + 1) * k)
                ctx = (torch.cuda.device(rep.device)
                       if rep.device.type == "cuda"
                       else contextlib.nullcontext())
                try:
                    with ctx:
                        out[i] = rep._dispatch(img[rows], sig[rows],
                                               clin[rows])
                except BaseException as e:  # raised on the batcher thread
                    out[i] = e

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_data)]
            with no_tf32():
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            for o in out:
                if isinstance(o, BaseException):
                    raise o
            rows = np.concatenate([o[0] for o in out])
            return rows, np.full(rows.shape[0], max(o[1] for o in out))

        run_slices.replicas = replicas
        self._mesh_fns[n_data] = run_slices
        return run_slices

    def enable_batching(
        self,
        window_ms: float = 4.0,
        max_batch: Optional[int] = None,
        buckets: Optional[Tuple[int, ...]] = None,
        n_data: int = 1,
    ) -> None:
        """Coalesce concurrent predict() calls into bucketed dispatches of
        `_predict_many` (serve/batching.py). n_data > 1 is JAX's mesh
        serving: n_data replicas of the model on the first n_data visible
        devices (`parallel/mesh.visible_devices`) answer each bucketed
        dispatch together, an equal row slice each (`_mesh_batch_fn`);
        the buckets must divide by n_data and default to n_data * (1, 2,
        4, 8), and a re-enable reuses the replicas. Requests are
        independent row by row, so the responses are the single-device
        ones. A pipeline loaded from a bundle serves the buckets it was
        exported with (all of them by default), on one device."""
        if n_data < 1:
            raise ValueError(f"n_data must be >= 1, got {n_data}")
        if n_data > 1 and self.model is None:
            raise ValueError(
                "mesh serving (n_data > 1) needs a live model — an AOT "
                "bundle is a fixed single-device program")
        exported = self._exported_buckets
        if self.model is None and not exported:
            raise ValueError(
                "this pipeline has no batched request program — export "
                "the bundle with batch_buckets=(8,) (or more buckets) to "
                "serve batched from AOT")
        if n_data > 1:
            visible = len(meshlib.visible_devices(self.device))
            if n_data > visible:
                raise ValueError(
                    f"n_data={n_data} exceeds the {visible} visible "
                    "device(s)"
                )
        if buckets is None:
            buckets = exported or tuple(max(n_data, 1) * b
                                        for b in (1, 2, 4, 8))
        buckets = tuple(buckets)
        if exported is not None and not set(buckets) <= set(exported):
            raise ValueError(
                f"requested batch buckets {buckets} not all exported "
                f"(bundle has {exported})")
        if self.model is None:
            self._load_exported_batched()
        if n_data > 1:
            bad = tuple(b for b in buckets if b % n_data)
            if bad:
                raise ValueError(
                    f"batch buckets {bad} not divisible by n_data={n_data} "
                    "— each device must take an equal slice of every "
                    "bucketed dispatch")
        if max_batch is None:
            max_batch = max(buckets)
        fn = self._batch_fn if n_data == 1 else self._mesh_batch_fn(n_data)
        # construct (and validate) the new batcher before tearing down a
        # live one, so a bad re-enable never leaves batching silently off
        new = batching.MicroBatcher(fn, window_ms=window_ms,
                                    max_batch=max_batch, buckets=buckets)
        self.close_batching()
        self._batcher = new
        self._serve_n_data = n_data

    def close_batching(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        self._serve_n_data = 1

    def _zeros(self, b: int):
        h, w = self.img_hw
        return (np.zeros((b, 3, h, w), np.float32),
                np.zeros((b, self.signal_len), np.float32),
                np.zeros((b, self.n_clin), np.float32))

    def warmup_batched(self) -> None:
        """Run every batch bucket's program once up front (cuDNN plans and
        allocator blocks for each bucket's shapes)."""
        if self._batcher is None:
            return
        for b in self._batcher._buckets:
            self._batcher._batch_fn(*self._zeros(b))

    def warmup(self, strip_hw: Tuple[int, int] = (250, 2500)) -> None:
        """One request through the whole path at startup, so the first
        real request does not pay the first-call costs; the counters are
        reset afterwards."""
        dummy = np.full(strip_hw + (3,), 255, np.uint8)
        dummy[strip_hw[0] // 2, :, :] = 0
        self.predict(dummy, {"age": 60, "weight": 70})
        if self._batcher is not None:
            # with batching on, predict() went through the batcher: run the
            # unbatched program too, which a BatcherClosed race takes
            self._dispatch(*self._zeros(1))
        with self._stats_lock:
            self._n_requests = 0
            self._latency_sum = 0.0
            self._latency_hist = [0] * len(LATENCY_BUCKETS)

    # -- the request -------------------------------------------------------

    def predict(self, image_u8: np.ndarray, questionnaire: Dict,
                heatmap_format: str = "png") -> Dict:
        """One request: an RGB uint8 strip photo and the questionnaire ->
        the ResultScreen response. heatmap_format "png" returns the
        base64 PNG overlay; "jpeg" the base64 JPEG overlay (quality 85)
        with heatmap_mime; "cam" returns the raw low-resolution CAM
        under heatmap_cam and an empty heatmap."""
        t0 = time.perf_counter()
        request_host.check_heatmap_format(heatmap_format)
        (img_norm, sig, clin, mv, dig_info, age, image_u8
         ) = request_host.prepare_inputs(self, image_u8, questionnaire)
        img = img_norm.transpose(0, 3, 1, 2)  # (1, 3, H, W)
        t1 = time.perf_counter()
        # Snapshot the batcher once: a concurrent close_batching() between
        # a None check and submit() would otherwise fail the request.
        batcher = self._batcher
        row = None
        if batcher is not None:
            try:
                row, device_ms = batcher.submit(img[0], sig[0], clin[0])
            except batching.BatcherClosed:
                # close_batching() raced this request: it was never
                # dispatched, so it takes the unbatched path. A
                # BatchDispatchError propagates: a failing batched program
                # must surface, not silently degrade.
                row = None
        if row is None:
            rows, device_ms = self._dispatch(img, sig, clin)
            row = rows[0]
        t2 = time.perf_counter()
        probs, pred, cam, attr, ca = self._unpack(row)
        resp = request_host.assemble_response(
            self, mv=mv, dig_info=dig_info, image_u8=image_u8,
            questionnaire=questionnaire, probs=probs, pred=pred,
            cam=cam, attr=attr, ca_a=ca, age=age,
            heatmap_format=heatmap_format,
        )
        t3 = time.perf_counter()
        self.last_timing = {
            "host_before_ms": (t1 - t0) * 1e3,
            "device_ms": float(device_ms),
            "host_after_ms": (t3 - t2) * 1e3,
            "total_ms": (t3 - t0) * 1e3,
        }
        dt = t3 - t0
        with self._stats_lock:
            self._n_requests += 1
            self._latency_sum += dt
            for i, ub in enumerate(LATENCY_BUCKETS):
                if dt <= ub:
                    self._latency_hist[i] += 1
                    break
        hook = self.on_request_done
        if hook is not None:
            hook()
        return resp

    # -- counters ------------------------------------------------------------

    def record_error(self) -> None:
        """Count a request answered 4xx/5xx (called by the HTTP handler;
        predict() itself sees only requests that reached the model)."""
        with self._stats_lock:
            self._n_errors += 1

    def stats(self) -> Dict:
        """Operational counters (the /stats endpoint)."""
        with self._stats_lock:
            n, lat = self._n_requests, self._latency_sum
            errs = self._n_errors
        out = {
            "requests": n,
            "errors": errs,
            "mean_latency_ms": (lat / n * 1e3) if n else 0.0,
            "aot": self.model is None,
            "temperature": self.temperature,
            "device": str(self.device),
            "batching": None,
        }
        b = self._batcher
        if b is not None:
            out["batching"] = b.stats()
            out["batching"]["n_data"] = self._serve_n_data
        return out

    def metrics(self) -> str:
        """The /stats counters in Prometheus text exposition format
        (version 0.0.4): request and error counters, the predict()
        latency histogram over LATENCY_BUCKETS, the micro-batcher's
        dispatch gauges, the process's RSS and, on the card, the bytes
        PyTorch's allocator holds there."""
        with self._stats_lock:
            n, lat = self._n_requests, self._latency_sum
            errs = self._n_errors
            hist = list(self._latency_hist)
        lines = [
            "# HELP ecgmm_requests_total Requests served a prediction.",
            "# TYPE ecgmm_requests_total counter",
            f"ecgmm_requests_total {n}",
            "# HELP ecgmm_request_errors_total Requests answered "
            "4xx/5xx.",
            "# TYPE ecgmm_request_errors_total counter",
            f"ecgmm_request_errors_total {errs}",
            "# HELP ecgmm_request_latency_seconds End-to-end predict() "
            "latency (digitize + device dispatch + explainers + "
            "heatmap encode).",
            "# TYPE ecgmm_request_latency_seconds histogram",
        ]
        cum = 0
        for ub, c in zip(LATENCY_BUCKETS, hist):
            cum += c
            le = "+Inf" if ub == float("inf") else f"{ub:g}"
            lines.append(
                f'ecgmm_request_latency_seconds_bucket{{le="{le}"}} {cum}'
            )
        lines.append(f"ecgmm_request_latency_seconds_sum {lat:.6f}")
        lines.append(f"ecgmm_request_latency_seconds_count {n}")
        b = self._batcher
        lines += [
            "# HELP ecgmm_batching_enabled Micro-batching active (gauge).",
            "# TYPE ecgmm_batching_enabled gauge",
            f"ecgmm_batching_enabled {0 if b is None else 1}",
        ]
        if b is not None:
            s = b.stats()
            lines += [
                "# TYPE ecgmm_batch_dispatches_total counter",
                f"ecgmm_batch_dispatches_total {s['dispatches']}",
                "# TYPE ecgmm_batch_requests_total counter",
                f"ecgmm_batch_requests_total {s['requests']}",
                "# HELP ecgmm_batch_mean_coalescence Requests per device "
                "dispatch since startup (gauge).",
                "# TYPE ecgmm_batch_mean_coalescence gauge",
                f"ecgmm_batch_mean_coalescence {s['mean_coalescence']:.4f}",
            ]
        lines += [
            "# HELP ecgmm_process_rss_bytes Resident set size of the "
            "serving process.",
            "# TYPE ecgmm_process_rss_bytes gauge",
            f"ecgmm_process_rss_bytes {_rss_bytes()}",
        ]
        if self.device.type == "cuda":
            lines += [
                "# HELP ecgmm_live_buffer_bytes Bytes of live tensors on "
                "the serving device (torch.cuda.memory_allocated).",
                "# TYPE ecgmm_live_buffer_bytes gauge",
                "ecgmm_live_buffer_bytes "
                f"{torch.cuda.memory_allocated(self.device)}",
            ]
        return "\n".join(lines) + "\n"
