"""Request/response wire helpers (port of `ecgmm_tpu/serve/wire.py`): the
mobile app's endpoint path (`Groove/components/SubmitButton.tsx:35-48`),
a minimal multipart/form-data codec, questionnaire field coercion, and
the client-defect exception the HTTP front end answers with 400.
Everything here is bytes/str-shaped: no model, no torch."""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

ENDPOINT = "/api/public/upload-ecgImage-lead2only"


class BadRequest(ValueError):
    """Client-side request defect (the HTTP front end answers 400)."""


def _sex_from_questionnaire(q: Dict) -> Optional[str]:
    """The questionnaire form posts the radio key 'gender' ('0'=male,
    '1'=female); an explicit 'sex' string wins."""
    sex = q.get("sex")
    if sex not in (None, ""):
        return str(sex)
    return {"0": "M", "1": "F"}.get(str(q.get("gender", "")))


def parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """Minimal multipart/form-data parser (stdlib cgi is deprecated)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts = body.split(b"--" + boundary)
    fields: Dict[str, bytes] = {}
    for part in parts:
        # exactly one delimiter CRLF on each side: bytes.strip(b"\r\n")
        # would also eat trailing CR/LF bytes of a binary field
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        nm = re.search(rb'name="([^"]+)"', header_blob)
        if nm:
            fields[nm.group(1).decode()] = content
    return fields


def encode_multipart(
    fields: Dict[str, Tuple[Optional[str], bytes]],
    boundary: str = "ecgmmboundary42",
) -> Tuple[bytes, str]:
    """Inverse of parse_multipart: {name: (filename|None, content)} ->
    (body, Content-Type). Where a field's bytes contain the boundary (an
    arbitrary JPEG may), the boundary is lengthened until it collides
    with nothing, so the parser never truncates the upload."""
    blobs = [content for _, content in fields.values()]
    while any(boundary.encode() in c for c in blobs):
        boundary += "x"
    lines = []
    for name, (filename, content) in fields.items():
        lines.append(f"--{boundary}".encode())
        disp = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        lines.append(disp.encode())
        lines.append(b"")
        lines.append(content)
    lines.append(f"--{boundary}--".encode())
    return (
        b"\r\n".join(lines),
        f"multipart/form-data; boundary={boundary}",
    )
