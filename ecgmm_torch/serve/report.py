"""Rule-based clinical report (port of the offline backend of
`ecgmm_tpu/serve/report.py`).

The reference sends the Grad-CAM overlay to GPT-4o and extracts five
sections (the reference repository's `gpt/gpt_analysis.py:7-153`);
`rule_based_report` fills the same section contract
{"RR 간격", "QRS 파형", "T파", "P파", "임상 권고"} from measured signal
statistics, so every response carries a complete gpt_result. The OpenAI
backend is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

SECTIONS = ["RR 간격", "QRS 파형", "T파", "P파", "임상 권고"]


def detect_r_peaks(signal: np.ndarray, fs: float = 250.0) -> np.ndarray:
    """Simple R-peak detector: threshold crossings on the positive
    envelope with a 200 ms refractory period. The threshold anchors on
    the 99th percentile, not the max: a single photo-artifact spike
    (smudge, pen mark) above the true R amplitude would otherwise raise
    a max-based threshold past every real beat and blank the report's
    rhythm section."""
    x = signal - np.median(signal)
    ref = float(np.percentile(x, 99.0))
    thresh = 0.5 * ref if ref > 0 else np.inf
    refractory = int(0.2 * fs)
    peaks = []
    i = 1
    while i < len(x) - 1:
        if x[i] >= thresh and x[i] >= x[i - 1] and x[i] >= x[i + 1]:
            peaks.append(i)
            i += refractory
        else:
            i += 1
    return np.asarray(peaks, np.int64)


def signal_features(signal: np.ndarray, fs: float = 250.0) -> Dict[str, float]:
    peaks = detect_r_peaks(signal, fs)
    if len(peaks) >= 3:
        rr = np.diff(peaks) / fs
        # median RR: one false beat from a photo artifact splits a
        # single interval and would drag a mean-based rate; the median
        # ignores it
        hr = 60.0 / np.median(rr)
        rr_cv = float(np.std(rr) / np.mean(rr))
    else:
        rr = np.asarray([])
        hr = float("nan")
        rr_cv = float("nan")
    return {
        "n_beats": float(len(peaks)),
        "heart_rate": float(hr),
        "rr_mean_s": float(np.mean(rr)) if len(rr) else float("nan"),
        "rr_cv": rr_cv,
    }


def rule_based_report(
    signal: np.ndarray,
    abnormal: bool,
    probability: float,
    age: Optional[float] = None,
    sex: Optional[str] = None,
    fs: float = 250.0,
) -> Dict[str, str]:
    f = signal_features(signal, fs)
    hr = f["heart_rate"]
    irregular = f["rr_cv"] > 0.15 if np.isfinite(f["rr_cv"]) else False

    rr_txt = (
        f"평균 RR 간격 {f['rr_mean_s']:.2f}초 (심박수 약 {hr:.0f}회/분), "
        + ("RR 간격의 변동성이 증가되어 불규칙한 리듬이 의심됩니다."
           if irregular else "RR 간격이 비교적 규칙적입니다.")
        if np.isfinite(hr)
        else "R파 검출이 불충분하여 RR 간격을 평가하기 어렵습니다."
    )
    qrs_txt = (
        "QRS 파형의 진폭과 폭은 측정 범위 내에서 특이 소견이 뚜렷하지 "
        "않습니다." if not abnormal else
        "QRS 파형에서 이상 소견 가능성이 있어 정밀 판독이 필요합니다."
    )
    t_txt = (
        "T파의 역위나 현저한 평탄화는 자동 분석에서 확인되지 않았습니다."
        if not abnormal else
        "T파 변화 가능성이 있습니다. 임상 소견과 함께 해석하십시오."
    )
    p_txt = (
        "P파가 각 QRS 앞에 관찰되는 양상입니다."
        if not irregular else
        "P파 식별이 불명확하며, 심방세동 등 심방성 부정맥을 감별해야 "
        "합니다."
    )
    rec = []
    if abnormal or irregular:
        rec.append("- 24시간 홀터(Holter) 검사 등 추가 리듬 평가를 권고합니다.")
        rec.append("- 심초음파 및 전해질 패널 검사를 고려하십시오.")
    else:
        rec.append("- 정기적인 건강검진과 생활습관 관리를 권고합니다.")
    if age is not None and age >= 65:
        rec.append("- 고령이므로 뇌졸중 위험 평가를 함께 고려하십시오.")
    rec.append(
        f"- 모델 판정: {'Abnormal' if abnormal else 'Normal'} "
        f"(확률 {probability:.2f}). 본 보고서는 자동 생성 참고용입니다."
    )
    return {
        "RR 간격": rr_txt,
        "QRS 파형": qrs_txt,
        "T파": t_txt,
        "P파": p_txt,
        "임상 권고": "\n".join(rec),
    }
