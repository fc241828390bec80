"""Time and peak memory of a JPEG 2000 upload's decode at the limits an
upload can reach, the port's (`ecgmm_torch.serve.imdecode.decode_upload`)
beside Pillow's (`Image.open(f).convert("RGB")`, what the JAX server
runs), on the CPU, as one JSON object.

    python3 tools/j2k_worst_cases.py [--root DIR] [--case NAME ...]

It needs Pillow with its openjpeg, which also writes the files:

- `tiles`: 65535 tiles, the most SIZ allows (255x257 tiles of 4x4 RGB
  pixels of noise, two resolutions), every tile-part's TNsot set to 0 so
  that openjpeg decodes the tiles only at EOC, in tile order (7.4 MB).
- `one_tile`: one tile of 13376x13376 RGB pixels, just under
  `imdecode.MAX_PIXELS`, the 250x2500 ECG strip of `strip.jpg` repeated
  over it, coded as the committed `strip_layers.jp2` is but at rates 80,
  40 and 20 so that it stays under the server's 32 MiB request cap.

Each decode runs in a fresh interpreter: `seconds` is the decode's wall
time, `peak_mib` the process's peak resident set (`VmHWM` in
/proc/self/status), `base_mib` its resident set before the decode (the
file read, the modules imported), and `equal`
whether the two RGB arrays are equal. `--root` names the repository whose
`ecgmm_torch` is measured (default: the one this file lies in), so that a
commit and its parent, unpacked with `git archive`, are measured by the
same code. The files are written under a temporary directory.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import hashlib, io, json, sys, time
root, path, who = sys.argv[1:4]


def status(key):
    with open("/proc/self/status") as f:
        line = next(l for l in f if l.startswith(key + ":"))
    return int(line.split()[1]) / 1024


sys.path.insert(0, root)
import numpy as np
data = open(path, "rb").read()
if who == "pillow":
    from PIL import Image
    decode = lambda d: np.asarray(Image.open(io.BytesIO(d)).convert("RGB"))
else:
    from ecgmm_torch import native
    from ecgmm_torch.serve.imdecode import decode_upload as decode
    native.library()
base = status("VmRSS")
t = time.perf_counter()
rgb = decode(data)
seconds = time.perf_counter() - t
print(json.dumps({"seconds": seconds, "peak_mib": status("VmHWM"),
                  "base_mib": base, "shape": list(rgb.shape),
                  "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}))
"""


def _tnsot_zero(data: bytes) -> bytes:
    out = bytearray(data)
    at = data.index(b"\xff\x90")
    while out[at:at + 2] == b"\xff\x90":
        out[at + 11] = 0
        at += struct.unpack_from(">I", out, at + 6)[0]
    return bytes(out)


def _save(pixels: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG2000", **kwargs)
    return buf.getvalue()


def make(case: str, root: str) -> bytes:
    if case == "tiles":
        rng = np.random.default_rng(0)
        noise = rng.integers(0, 256, (257 * 4, 255 * 4, 3), dtype=np.uint8)
        return _tnsot_zero(_save(noise, no_jp2=True, tile_size=(4, 4),
                                 num_resolutions=2))
    strip = np.asarray(Image.open(os.path.join(
        root, "ecgmm_torch/serve/fixtures/strip.jpg")).convert("RGB"))
    side = 13376
    reps = (-(-side // strip.shape[0]), -(-side // strip.shape[1]), 1)
    big = np.ascontiguousarray(np.tile(strip, reps)[:side, :side])
    return _save(big, quality_layers=[80, 40, 20])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--case", nargs="*", default=["tiles", "one_tile"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in args.case:
            data = make(case, root)
            path = os.path.join(tmp, case + ".j2k")
            with open(path, "wb") as f:
                f.write(data)
            got = {"bytes": len(data)}
            for who in ("pillow", "port"):
                run = subprocess.run([sys.executable, "-c", _CHILD, root,
                                      path, who], capture_output=True,
                                     text=True)
                if run.returncode:
                    raise SystemExit(f"{case} {who}: {run.stderr[-2000:]}")
                got[who] = json.loads(run.stdout.strip().splitlines()[-1])
            got["equal"] = got["pillow"].pop("sha256") == \
                got["port"].pop("sha256")
            out[case] = got
            print(case, json.dumps(got), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
