"""Clinical-document intake: PDF→PNG conversion + Korean health-check
field extraction.

Re-designs the reference's OCR tooling (`reference ocr/ocr.py:
54-187`, `ocr/pdf_to_png.py:10-13`): Google Cloud Vision supplies the raw
text there (commented-out live path); here the text source is pluggable
(`vision_ocr` is import-gated — no GCV/network in this environment) and
the extraction itself is pure regex over the same field set, returning the
clinical-feature row the trimodal pipeline consumes.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

FIELDS = [
    "연령", "성별", "수축기", "이완기", "흡연", "음주", "운동",
    "과거병력", "혈색소", "공복혈당", "총콜레스테롤", "고밀도 콜레스테롤",
    "중성지방", "저밀도 콜레스테롤", "AST", "ALT", "감마지티피",
    "혈청 크레아티닌", "키", "몸무게",
]

# keyword aliases per lab field (reference ocr.py:100-113)
_LAB_ALIASES = {
    "공복혈당": ["공복혈당", "혈당"],
    "총콜레스테롤": ["총콜레스테롤"],
    "고밀도 콜레스테롤": ["고밀도 콜레스테롤", "HDL"],
    "중성지방": ["중성지방"],
    "저밀도 콜레스테롤": ["저밀도 콜레스테롤", "LDL"],
    "AST": ["AST", "SGOT"],
    "ALT": ["ALT", "SGPT"],
    "혈색소": ["혈색소"],
    "혈청 크레아티닌": ["크레아티닌"],
    "감마지티피": ["감마지티피", "GTP"],
}

# The reference's number pattern (ocr.py:48): \d{1,3}\.?\d* matches
# 4+-digit values whole ('1250' → '1250'); a {1,3}-with-decimal-group
# variant would silently truncate them to '125'.
_NUM = r"\d{1,3}\.?\d*"


def _window_number(lines: List[str], i: int, span: int = 3
                   ) -> Optional[str]:
    """First number within ±`span` lines of the keyword (the reference's
    extract_value_from_window, ocr.py:44-51, scans -3..+3 so values
    printed above their keyword are found too). Offset ORDER deviates
    deliberately: same-line/below first, then above — the reference's
    strictly-ascending -3..+3 order prefers the PREVIOUS field's value
    over the keyword's own line whenever fields stack vertically."""
    for j in [0, 1, 2, 3, -1, -2, -3][:2 * span + 1]:
        k = i + j
        if 0 <= k < len(lines):
            nums = re.findall(_NUM, lines[k])
            if nums:
                return nums[0]
    return None


def extract_fields(text: str) -> Dict[str, object]:
    """OCR text → clinical field dict (empty string when absent)."""
    result: Dict[str, object] = {k: "" for k in FIELDS}
    lines = [ln.strip() for ln in text.split("\n") if ln.strip()]

    for ln in lines:
        m = re.search(r"연령\s*[:：]?\s*(\d{1,3})\s*세", ln)
        if m:
            result["연령"] = int(m.group(1))
            break

    for ln in lines:
        if "성별" in ln:
            if "남" in ln:
                result["성별"] = 0
            elif "여" in ln:
                result["성별"] = 1
            break

    for i, ln in enumerate(lines):
        if "키" in ln and ("몸무게" in ln or "체중" in ln):
            nums: List[str] = []
            for j in range(1, 4):
                if i + j < len(lines):
                    nums += re.findall(r"\d{2,3}\.?\d*", lines[i + j])
            if len(nums) >= 2:
                result["키"], result["몸무게"] = nums[0], nums[1]
            break

    for i, ln in enumerate(lines):
        if "고혈압" in ln or "혈압" in ln:
            for j in range(0, 4):
                if i + j < len(lines):
                    m = re.search(r"(\d{2,3})\s*/\s*(\d{2,3})", lines[i + j])
                    if m:
                        result["수축기"] = m.group(1)
                        result["이완기"] = m.group(2)
                        break
            if result["수축기"]:
                break

    for field, keywords in _LAB_ALIASES.items():
        for i, ln in enumerate(lines):
            if any(kw in ln for kw in keywords):
                val = _window_number(lines, i)
                if val:
                    result[field] = val
                    # break only once a value was extracted (reference
                    # ocr.py:115-121) — a keyword in a heading with no
                    # nearby number must not end the search
                    break

    # 혈색소 correction (reference ocr.py:123-130): hemoglobin is always
    # a d.d value; a dotless grab (OCR losing the decimal point, or a
    # neighboring integer) re-scans 혈색소 lines for \d{1,2}\.\d.
    if result["혈색소"] and "." not in str(result["혈색소"]):
        for ln in lines:
            if "혈색소" in ln:
                m = re.findall(r"\d{1,2}\.\d", ln)
                if m:
                    result["혈색소"] = m[0]
                    break

    # Lifestyle sections (reference ocr.py:131-172): the national
    # health-check form puts a checkbox line (✅/■/☑ + category text)
    # under each of 흡연/음주/운동; map it to the reference's 0/1/2 codes.
    section = None
    checked: Dict[str, str] = {}
    for ln in lines:
        for key in ("흡연", "음주", "운동"):
            if key in ln:
                section = key
                break
        if section and any(box in ln for box in ("✅", "■", "☑")):
            checked[section] = ln
            section = None
    smoking = checked.get("흡연", "")
    if "과거 흡연자" in smoking:
        result["흡연"] = 1
    elif "현재 흡연자" in smoking or "전자담배" in smoking:
        result["흡연"] = 2
    elif "비흡연자" in smoking:
        result["흡연"] = 0
    drinking = checked.get("음주", "")
    if "비음주자" in drinking:
        result["음주"] = 0
    elif any(w in drinking for w in ("적정", "위험", "의심")):
        result["음주"] = 1
    exercise = checked.get("운동", "")
    if "건강증진" in exercise:
        result["운동"] = 2
    elif any(w in exercise for w in ("기본", "적절")):
        result["운동"] = 1
    elif "부족" in exercise:
        result["운동"] = 0

    # Inline shorthand fallback ('흡연 : 피움' style) for pluggable text
    # sources that aren't checkbox forms — only when the checkbox pass
    # produced nothing for that habit.
    for habit, yes_kw in (("흡연", "피움"), ("음주", "마심"), ("운동", "함")):
        if result[habit] != "":
            continue
        for ln in lines:
            if habit in ln:
                negated = ("안" + yes_kw in ln.replace(" ", "")) or (
                    "없" in ln
                )
                result[habit] = 0 if negated else (1 if yes_kw in ln else 0)
                break

    return result


def pdf_to_pngs(pdf_path: str, out_dir: str, dpi: int = 300) -> List[str]:
    """PDF → per-page PNGs (reference pdf_to_png.py:10-13). Import-gated
    on pdf2image/poppler."""
    import os

    from pdf2image import convert_from_path  # gated

    os.makedirs(out_dir, exist_ok=True)
    pages = convert_from_path(pdf_path, dpi=dpi)
    paths = []
    for i, page in enumerate(pages):
        p = os.path.join(out_dir, f"page_{i + 1}.png")
        page.save(p)
        paths.append(p)
    return paths


def vision_ocr(image_path: str) -> str:
    """Google Cloud Vision text detection (reference ocr.py:8-39).
    Import-gated — unavailable in zero-egress environments; plug any OCR
    text into extract_fields instead."""
    from google.cloud import vision  # gated

    client = vision.ImageAnnotatorClient()
    with open(image_path, "rb") as f:
        image = vision.Image(content=f.read())
    response = client.text_detection(image=image)
    if response.error.message:
        raise RuntimeError(response.error.message)
    return response.full_text_annotation.text


def fields_to_row(fields: Dict[str, object]) -> Dict[str, float]:
    """Extraction dict → the numeric clinical row (AGE/Wt first, matching
    the trimodal pipeline's column order)."""
    def num(v, default=float("nan")):
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    return {
        "AGE": num(fields.get("연령")),
        "Wt": num(fields.get("몸무게")),
        "Ht": num(fields.get("키")),
        "SBP": num(fields.get("수축기")),
        "DBP": num(fields.get("이완기")),
        "Hb": num(fields.get("혈색소")),
        "Glucose": num(fields.get("공복혈당")),
        "TC": num(fields.get("총콜레스테롤")),
        "HDL": num(fields.get("고밀도 콜레스테롤")),
        "TG": num(fields.get("중성지방")),
        "LDL": num(fields.get("저밀도 콜레스테롤")),
        "AST": num(fields.get("AST")),
        "ALT": num(fields.get("ALT")),
        "GGT": num(fields.get("감마지티피")),
        "Cr": num(fields.get("혈청 크레아티닌")),
        "Sex": num(fields.get("성별")),
    }
