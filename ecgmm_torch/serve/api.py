"""Serving API facade (port of `ecgmm_tpu/serve/api.py`): the import
surface of the serving modules, and the server's entry point.

    python -m ecgmm_torch.serve.api --synthetic --device cpu --port 8080

  * serve/pipeline.py — ServingPipeline: digitize -> infer -> Grad-CAM ->
    SHAP -> report, micro-batching glue and the Prometheus counters;
  * serve/loaders.py — assembly: a trained run, the demo;
  * serve/wire.py — endpoint path, multipart codec, questionnaire
    coercion, BadRequest;
  * serve/imdecode.py — the upload decoder (JPEG, PNG, EXIF orientation);
  * serve/http.py — the HTTP transport and the CLI.

Response JSON (the ResultScreen contract,
`Groove/app/(tabs)/ResultScreen.tsx:26-56`): label, probability,
ecg_signal [{"Voltage (mV)": v}...], heatmap (base64 PNG Grad-CAM
overlay), feature_importance {image, signal, age, wt} (percent),
gpt_result {five Korean sections}, digitization.
"""

from ecgmm_torch.serve.http import (  # noqa: F401
    MAX_REQUEST_BYTES,
    GracefulHTTPServer,
    install_graceful_shutdown,
    install_max_requests_recycle,
    main,
    make_handler,
    serve,
)
from ecgmm_torch.serve.imdecode import decode_upload  # noqa: F401
from ecgmm_torch.serve.pipeline import (  # noqa: F401
    LATENCY_BUCKETS,
    ServingPipeline,
)
from ecgmm_torch.serve.wire import (  # noqa: F401
    ENDPOINT,
    BadRequest,
    _sex_from_questionnaire,
    encode_multipart,
    parse_multipart,
)

if __name__ == "__main__":
    main()
