"""Frontend pages — capability parity with the reference templates
(SURVEY.md §2.4) as self-contained HTML (no CDN dependencies):

  * `logs_page()` — live dual-line training chart fed by the /chart-data SSE
    stream, with start/stop buttons and a range slider
    (reference: ECharts page `templates/index2.html:32-201`).
  * `map_page(markers, ...)` — per-class colored markers with tag-filter
    buttons and a density heat underlay on an SVG canvas
    (reference: folium/Leaflet page `templates/dense_sparse_heatmap.html`).
  * `heatmap_page(points)` — radial-gradient intensity heatmap over a
    lng/lat/count dataset (reference: AMap page `templates/map.html` +
    `static/heatmapData.js`).

All charts render with vanilla JS + SVG/canvas so the service works in
air-gapped deployments (the reference pages require ECharts/Leaflet/AMap
CDNs and an AMap API key).
"""
from __future__ import annotations

import json


# Mobile variant CSS: the reference ships a second logs page
# (`templates/index.html:12-46`) whose only delta is a
# landscape-rotate block (rotate the page 90deg and fill the viewport when a
# phone is held landscape).  Same chart, same SSE wiring.
_MOBILE_ROTATE_CSS = """
@media only screen and (orientation: landscape) {
  body{transform:rotate(90deg);transform-origin:top left;
       width:100vh;height:100vw;overflow-x:hidden;overflow-y:auto;margin:0}
  #chart{width:100%;height:100%}
}
"""


def logs_page(mobile: bool = False) -> str:
    extra = _MOBILE_ROTATE_CSS if mobile else ""
    return """<!doctype html><html><head><meta charset="utf-8">
<title>Training Metrics</title><style>""" + extra + """
body{font-family:system-ui;margin:2em;background:#fafafa}
#chart{background:#fff;border:1px solid #ddd;border-radius:6px}
.legend span{display:inline-block;margin-right:1.2em;font-size:13px}
.dot{display:inline-block;width:10px;height:10px;border-radius:5px;margin-right:4px}
button{margin-right:.5em;padding:.35em 1em}
</style></head><body>
<h3>Training metrics (live)</h3>
<button id="start">start</button><button id="stop">stop</button>
<div class="legend"><span><i class="dot" style="background:#c23531"></i>Train acc</span>
<span><i class="dot" style="background:#2f4554"></i>Val acc</span></div>
<svg id="chart" width="860" height="360"></svg>
<div><input type="range" id="zoom" min="10" max="100" value="100" style="width:860px">
<label for="zoom" style="font-size:12px">window %</label></div>
<script>
const data = [];
let es = null;
const svg = document.getElementById('chart');
const W = 860, H = 360, PAD = 40;
function draw() {
  const frac = document.getElementById('zoom').value / 100;
  const view = data.slice(Math.floor(data.length * (1 - frac)));
  svg.innerHTML = '';
  if (!view.length) return;
  const ys = view.flatMap(d => [d.value1, d.value2]);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const yr = (ymax - ymin) || 1;
  const sx = i => PAD + i * (W - 2 * PAD) / Math.max(view.length - 1, 1);
  const sy = v => H - PAD - (v - ymin) / yr * (H - 2 * PAD);
  // axes + gridlines
  for (let g = 0; g <= 4; g++) {
    const y = PAD + g * (H - 2 * PAD) / 4;
    svg.innerHTML += `<line x1="${PAD}" y1="${y}" x2="${W-PAD}" y2="${y}"
      stroke="#eee"/><text x="4" y="${y+4}" font-size="10">${
      (ymax - g * yr / 4).toFixed(3)}</text>`;
  }
  for (const [key, color] of [['value1','#c23531'],['value2','#2f4554']]) {
    const pts = view.map((d, i) => `${sx(i)},${sy(d[key])}`).join(' ');
    svg.innerHTML += `<polyline points="${pts}" fill="none" stroke="${color}"
      stroke-width="2"/>`;
  }
}
document.getElementById('start').onclick = () => {
  if (es) return;
  es = new EventSource('/chart-data');
  es.onmessage = e => { data.push(JSON.parse(e.data)); draw(); };
};
document.getElementById('stop').onclick = () => { if (es) { es.close(); es = null; } };
document.getElementById('zoom').oninput = draw;
</script></body></html>"""


_CLASS_COLORS = {"good": "#6fbf73", "broke": "#e58bb0", "lose": "#9e9e9e",
                 "uncovered": "#f29b38", "circle": "#6fb3e0"}


def _js_payload(obj) -> str:
    """JSON safe to embed inside a <script> element: json.dumps leaves '<'
    alone, so a user-supplied string containing '</script>' would END the
    script element mid-JSON (HTML parsing ignores JS string context) and
    inject attacker markup — stored XSS via e.g. the objects[0]['sort']
    field of POST /getImage.  \\u003c is identical JSON, inert in HTML."""
    return json.dumps(obj).replace("<", "\\u003c")


def map_page(markers: list[dict], center: tuple[float, float],
             location_label: str = "") -> str:
    """markers: [{lat, lng, cls}] -> filterable SVG scatter + heat density."""
    import html as _html
    payload = _js_payload({"markers": markers, "center": center,
                           "colors": _CLASS_COLORS})
    # location_label is the raw ?location= query value — escape it or
    # GET /map?location=<script>... is reflected XSS
    label = _html.escape(location_label)
    return """<!doctype html><html><head><meta charset="utf-8">
<title>Cover Map</title><style>
body{font-family:system-ui;margin:2em;background:#fafafa}
#map{background:#eef3ee;border:1px solid #ccc;border-radius:6px}
.filter button{margin:2px;padding:.3em .9em;border-radius:12px;border:1px solid #bbb;cursor:pointer}
.filter button.off{opacity:.35}
</style></head><body>
<h3>Manhole covers """ + (f"near {label}" if label else "") + """</h3>
<div class="filter" id="filters"></div>
<svg id="map" width="760" height="560"></svg>
<script>
const D = """ + payload + """;
// markers may carry classes beyond the five known colors (POST /getImage
// stores objects[0]['sort'] verbatim) — they get a filter button and a
// gray dot instead of being silently dropped
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const classes = [...new Set([...Object.keys(D.colors),
                             ...D.markers.map(m => String(m.cls))])];
const active = Object.fromEntries(classes.map(c => [c, true]));
const svg = document.getElementById('map');
const W = 760, H = 560;
// the geocoded center joins the extents so the requested location is in
// view (the reference page centers on it)
const lats = D.markers.map(m => m.lat), lngs = D.markers.map(m => m.lng);
if (D.center) { lats.push(D.center[1]); lngs.push(D.center[0]); }
const la0 = Math.min(...lats), la1 = Math.max(...lats);
const lo0 = Math.min(...lngs), lo1 = Math.max(...lngs);
const sx = lng => 30 + (lng - lo0) / ((lo1 - lo0) || 1) * (W - 60);
const sy = lat => H - 30 - (lat - la0) / ((la1 - la0) || 1) * (H - 60);
function draw() {
  let out = '';
  // heat underlay: translucent blobs
  for (const m of D.markers) {
    if (!active[m.cls]) continue;
    out += `<circle cx="${sx(m.lng)}" cy="${sy(m.lat)}" r="26"
      fill="rgba(240,120,40,0.06)"/>`;
  }
  for (const m of D.markers) {
    if (!active[m.cls]) continue;
    out += `<circle cx="${sx(m.lng)}" cy="${sy(m.lat)}" r="6"
      fill="${esc(D.colors[m.cls] || '#8a8a8a')}" stroke="#555" stroke-width="1">
      <title>${esc(m.cls)} @ ${m.lat.toFixed(4)},${m.lng.toFixed(4)}</title></circle>`;
  }
  if (D.center)
    out += `<path d="M ${sx(D.center[0]) - 8} ${sy(D.center[1])} h 16
      M ${sx(D.center[0])} ${sy(D.center[1]) - 8} v 16"
      stroke="#c33" stroke-width="2"/>`;
  svg.innerHTML = out;
}
const fdiv = document.getElementById('filters');
for (const cls of classes) {
  const b = document.createElement('button');
  b.textContent = cls;
  b.style.background = D.colors[cls] || '#8a8a8a';
  b.onclick = () => { active[cls] = !active[cls];
    b.classList.toggle('off'); draw(); };
  fdiv.appendChild(b);
}
draw();
</script></body></html>"""


def heatmap_page(points: list[dict]) -> str:
    """points: [{lng, lat, count}] -> canvas radial-gradient heatmap."""
    payload = _js_payload(points)
    return """<!doctype html><html><head><meta charset="utf-8">
<title>Cover Density Heatmap</title><style>
body{font-family:system-ui;margin:2em;background:#111;color:#eee}
canvas{border:1px solid #444;border-radius:6px;background:#1c2330}
</style></head><body>
<h3>Cover density</h3>
<canvas id="heat" width="860" height="600"></canvas>
<script>
const pts = """ + payload + """;
const cv = document.getElementById('heat'), ctx = cv.getContext('2d');
if (pts.length) {
  const lo0 = Math.min(...pts.map(p => p.lng)), lo1 = Math.max(...pts.map(p => p.lng));
  const la0 = Math.min(...pts.map(p => p.lat)), la1 = Math.max(...pts.map(p => p.lat));
  const maxc = Math.max(...pts.map(p => p.count));
  for (const p of pts) {
    const x = 30 + (p.lng - lo0) / ((lo1 - lo0) || 1) * (cv.width - 60);
    const y = cv.height - 30 - (p.lat - la0) / ((la1 - la0) || 1) * (cv.height - 60);
    const w = p.count / maxc;
    const r = 12 + 30 * w;
    const g = ctx.createRadialGradient(x, y, 0, x, y, r);
    g.addColorStop(0, `rgba(${255},${Math.round(220-180*w)},40,${0.25+0.5*w})`);
    g.addColorStop(1, 'rgba(255,120,40,0)');
    ctx.fillStyle = g;
    ctx.beginPath(); ctx.arc(x, y, r, 0, 7); ctx.fill();
  }
}
</script></body></html>"""
