"""Minimal browser client for the serving API — a stand-in for the
reference's Expo/React-Native app (`Groove/`): questionnaire + ECG-strip
upload → renders label/probability, the digitized waveform, the Grad-CAM
heatmap toggle, the modality-importance breakdown and the clinical report
(the exact ResultScreen.tsx surface), against the same endpoint."""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ecgmm_torch</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:860px;margin:2rem auto;padding:0 1rem}
 fieldset{border:1px solid #ccc;border-radius:8px;margin-bottom:1rem}
 label{display:inline-block;min-width:7rem;margin:.2rem 0}
 #result{display:none}
 .label-badge{font-size:1.4rem;font-weight:700}
 .Normal{color:#15803d}.Abnormal{color:#b91c1c}
 canvas{width:100%;border:1px solid #eee}
 img#heatmap{width:100%;display:none}
 .bar{height:14px;background:#e5e7eb;border-radius:7px;overflow:hidden;margin:2px 0 8px}
 .bar>div{height:100%}
 .report p{background:#f8fafc;border-left:3px solid #64748b;padding:.5rem;white-space:pre-wrap}
</style></head><body>
<h1>ecgmm_torch — ECG analysis</h1>
<form id="f">
<fieldset><legend>Questionnaire</legend>
  <label>Age</label><input name="age" type="number" value="60" required><br>
  <label>Height (cm)</label><input name="height" type="number" value="170" required><br>
  <label>Weight (kg)</label><input name="weight" type="number" value="70" required><br>
  <label>Sex</label><select name="sex"><option>F</option><option>M</option></select>
</fieldset>
<fieldset><legend>Lead-II ECG strip</legend>
  <input id="file" type="file" accept="image/*" required>
</fieldset>
<button type="submit">Analyze</button> <span id="status"></span>
</form>
<div id="result">
  <h2>Result: <span class="label-badge" id="label"></span>
      <small id="prob"></small></h2>
  <label><input type="checkbox" id="toggle"> show Grad-CAM heatmap</label>
  <canvas id="wave" height="160"></canvas>
  <img id="heatmap">
  <h3>Feature importance</h3><div id="fi"></div>
  <h3>Clinical report</h3><div class="report" id="report"></div>
</div>
<script>
const f = document.getElementById('f');
f.addEventListener('submit', async (e) => {
  e.preventDefault();
  const fd = new FormData();
  fd.append('file', document.getElementById('file').files[0]);
  fd.append('questionnaire', JSON.stringify(
    Object.fromEntries(new FormData(f).entries())));
  document.getElementById('status').textContent = 'analyzing…';
  let r;
  try {
    r = await fetch('/api/public/upload-ecgImage-lead2only',
                    {method: 'POST', body: fd});
  } catch (err) {  // network-level failure: don't hang on 'analyzing…'
    document.getElementById('status').textContent =
      'network error: ' + err.message;
    return;
  }
  if (!r.ok) {
    let msg = 'error ' + r.status;
    try { msg += ': ' + (await r.json()).error; } catch (_) {}
    document.getElementById('status').textContent = msg;
    return;
  }
  const d = await r.json();
  document.getElementById('status').textContent = '';
  document.getElementById('result').style.display = 'block';
  const lbl = document.getElementById('label');
  lbl.textContent = d.label; lbl.className = 'label-badge ' + d.label;
  document.getElementById('prob').textContent =
    ' (p=' + d.probability.toFixed(3) + ')';
  // digitization-quality warning: without a detected calibration grid
  // the voltage axis is an assumed scale, not measured millivolts
  const st = document.getElementById('status');
  if (d.digitization && d.digitization.scale_source === 'assumed')
    st.textContent = 'warning: no calibration grid found in the photo; ' +
      'voltage scale is assumed, not measured';
  // waveform
  const c = document.getElementById('wave'); c.width = c.clientWidth;
  const ctx = c.getContext('2d'); ctx.clearRect(0,0,c.width,c.height);
  const v = d.ecg_signal.map(p => p['Voltage (mV)']);
  const lo = Math.min(...v), hi = Math.max(...v);
  ctx.beginPath();
  v.forEach((y,i) => { const px = i/(v.length-1)*c.width,
    py = c.height - (y-lo)/(hi-lo+1e-9)*(c.height-10) - 5;
    i ? ctx.lineTo(px,py) : ctx.moveTo(px,py); });
  ctx.stroke();
  // heatmap toggle
  const img = document.getElementById('heatmap');
  img.src = 'data:image/png;base64,' + d.heatmap;
  document.getElementById('toggle').onchange = (ev) =>
    img.style.display = ev.target.checked ? 'block' : 'none';
  // feature importance bars
  const colors = {image:'#facc15', signal:'#4ade80', age:'#60a5fa', wt:'#c084fc'};
  document.getElementById('fi').innerHTML =
    Object.entries(d.feature_importance).map(([k,val]) =>
      `<label>${k}: ${val.toFixed(1)}%</label>
       <div class="bar"><div style="width:${val}%;background:${colors[k]}"></div></div>`
    ).join('');
  // report sections — textContent, never innerHTML: with the GPT
  // backend the section bodies are model-generated text and must not be
  // interpreted as markup
  const rep = document.getElementById('report');
  rep.replaceChildren(...Object.entries(d.gpt_result).flatMap(([k,v]) => {
    const h = document.createElement('h4'); h.textContent = k;
    const p = document.createElement('p'); p.textContent = v;
    return [h, p];
  }));
});
</script></body></html>
"""
