"""Request helpers shared by the serving path (port of the parts of
`ecgmm_tpu/serve/wire.py` the pipeline uses; the multipart codec belongs
to the HTTP front end, which is not ported yet)."""

from __future__ import annotations

from typing import Dict, Optional


class BadRequest(ValueError):
    """Client-side request defect (an HTTP front end answers 400)."""


def _sex_from_questionnaire(q: Dict) -> Optional[str]:
    """The questionnaire form posts the radio key 'gender' ('0'=male,
    '1'=female); an explicit 'sex' string wins."""
    sex = q.get("sex")
    if sex not in (None, ""):
        return str(sex)
    return {"0": "M", "1": "F"}.get(str(q.get("gender", "")))
