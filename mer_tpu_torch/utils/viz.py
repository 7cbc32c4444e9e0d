"""Embedding-space visualisation (counterpart of ``mer_tpu/utils/viz.py``):
PCA -> t-SNE projection, silhouette score, PNG and standalone HTML scatters,
and their uploads through the run logger.

``mer_tpu`` calls scikit-learn (``PCA(random_state=0)``, ``TSNE``,
``silhouette_score``) and matplotlib; the card's machine has neither, so
this module computes the same things in torch on a device of the caller's
choosing (the card unless it asks for the CPU), in float64:

- :func:`pca` is scikit-learn's full-SVD PCA: centred data, ``svd_flip``'s
  sign convention (each component's largest-magnitude loading positive);
- :func:`tsne` is scikit-learn's exact-gradient t-SNE with its schedule: a
  binary search per row for the precision that gives the perplexity (100
  steps, entropy tolerance 1e-5), symmetrised joint probabilities,
  ``init="pca"`` scaled to a first-axis standard deviation of 1e-4,
  ``learning_rate="auto"`` (max(N / 12 / 4, 50)), early exaggeration 12 for
  250 iterations at momentum 0.5, then momentum 0.8 to ``max_iter`` 1000,
  per-coordinate gains (+0.2 / x0.8, at least 0.01), a Student-t of
  max(dims - 1, 1) degrees of freedom, and a progress check every 50
  iterations (300 without progress, or a gradient norm of 1e-7, stops);
- :func:`silhouette` is ``silhouette_score`` on the raw embeddings (0.0 for
  fewer than two classes, as ``mer_tpu``'s);
- :func:`write_scatter_png` rasterises the scatter itself (filled discs in
  the tab10 palette at 0.7 opacity over white; in 3D the HTML view's
  rotation, perspective and depth order) and writes the PNG with ``zlib``
  and ``struct``, so it always writes a file;
- :func:`write_scatter_html` writes ``mer_tpu``'s standalone page (its
  template copied here): the same bytes as ``mer_tpu``'s without plotly.

The projection is scikit-learn's in method and schedule, not in its bits:
scikit-learn's default is the Barnes-Hut approximation, and it runs t-SNE's
parameters in float32.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np
import torch

# matplotlib tab10, the categorical palette of both scatters
PALETTE = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]
ALPHA = 0.7  # the scatters' opacity ('b3' in the HTML page)
CANVAS = 800  # pixels a side, as the HTML page's canvas
EXAGGERATION_ITERS = 250
_EPS = float(np.finfo(np.float64).eps)


def _device(x, device) -> torch.device:
    """``device``, else the tensor's, else the card (raising without one)."""
    if device is not None:
        device = torch.device(device)
    elif isinstance(x, torch.Tensor):
        device = x.device
    else:
        device = torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the visualisation runs on the card by default, and torch.cuda.is_available() is "
                           "false; pass device='cpu' to run it on the CPU")
    return device


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
        _device(x, device), torch.float64)


def pca(x, n_components: int | None = None, device=None) -> torch.Tensor:
    """scikit-learn's ``PCA(...).fit_transform(x)`` (full SVD): the centred
    data on the first ``n_components`` (default all) principal axes, float64."""
    x = _f64(x, device)
    xc = x - x.mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    signs = torch.sign(vt.gather(1, vt.abs().argmax(1, keepdim=True)))
    vt = vt * signs
    k = vt.shape[0] if n_components is None else n_components
    return xc @ vt[:k].T


def _conditional_p(sqdist: torch.Tensor, perplexity: float, steps: int = 100, tol: float = 1e-5) -> torch.Tensor:
    """scikit-learn's ``_binary_search_perplexity``: per row the precision
    beta whose conditional distribution exp(-beta d) has entropy
    log(perplexity), found by bisection from beta 1 (doubling or halving
    while unbounded); a row stops at the first beta within ``tol``."""
    n = sqdist.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=sqdist.device)
    beta = torch.ones(n, dtype=torch.float64, device=sqdist.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    used = beta.clone()
    active = torch.ones(n, dtype=torch.bool, device=sqdist.device)
    want = math.log(perplexity)

    def row_p(b):
        p = torch.exp(-sqdist * b[:, None]) * off
        total = p.sum(1).clamp_min(1e-8)
        return p / total[:, None], total

    for _ in range(steps):
        p, total = row_p(beta)
        entropy = torch.log(total) + beta * (sqdist * p).sum(1)
        diff = entropy - want
        used = torch.where(active, beta, used)
        active = active & (diff.abs() > tol)
        if not bool(active.any()):
            break
        up = active & (diff > 0)
        down = active & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2), beta)
    return row_p(used)[0]


def _kl_and_grad(y: torch.Tensor, p: torch.Tensor, dof: float, off: torch.Tensor):
    """KL(P || Q) and its gradient for a Student-t of ``dof`` degrees of
    freedom (scikit-learn's ``_kl_divergence`` over the full matrices)."""
    sq = ((y[:, None] - y[None]) ** 2).sum(-1)
    w = (1.0 + sq / dof).pow(-(dof + 1.0) / 2.0) * off
    q = (w / w.sum()).clamp_min(_EPS)
    kl = (p * torch.log(p.clamp_min(_EPS) / q) * off).sum()
    pqw = (p - q) * w * off
    grad = (2.0 * (dof + 1.0) / dof) * (pqw.sum(1, keepdim=True) * y - pqw @ y)
    return kl, grad


def tsne(x, n_components: int = 2, perplexity: float = 30.0, early_exaggeration: float = 12.0,
         max_iter: int = 1000, device=None) -> tuple[torch.Tensor, float]:
    """scikit-learn's ``TSNE(n_components, perplexity, init="pca",
    method="exact").fit_transform(x)`` schedule in float64: returns the
    embedding [N, n_components] and the final KL divergence."""
    x = _f64(x, device)
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError("perplexity must be less than n_samples")
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    sqdist = ((x[:, None] - x[None]) ** 2).sum(-1)
    cond = _conditional_p(sqdist, perplexity)
    joint = cond + cond.T
    p = (joint / joint.sum().clamp_min(_EPS)).clamp_min(_EPS) * off
    y = pca(x, n_components)
    y = y / y[:, 0].std(correction=0) * 1e-4
    dof = float(max(n_components - 1, 1))
    lr = max(n / early_exaggeration / 4, 50.0)

    def descend(y, p, it, stop, momentum, patience):
        update, gains = torch.zeros_like(y), torch.ones_like(y)
        best_error, best_iter, error = math.inf, it, math.inf
        i = it
        for i in range(it, stop):
            error, grad = _kl_and_grad(y, p, dof, off)
            inc = update * grad < 0.0
            gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(0.01)
            grad = grad * gains
            update = momentum * update - lr * grad
            y = y + update
            if (i + 1) % 50 == 0:
                error = float(error)
                if error < best_error:
                    best_error, best_iter = error, i
                elif i - best_iter > patience:
                    break
                if float(torch.linalg.vector_norm(grad)) <= 1e-7:
                    break
        return y, float(error), i

    y, _, it = descend(y, p * early_exaggeration, 0, EXAGGERATION_ITERS, 0.5, EXAGGERATION_ITERS)
    y, kl, _ = descend(y, p, it + 1, max_iter, 0.8, 300)
    return y, kl


def project_embeddings(embeddings, kind: str = "2D", device=None) -> np.ndarray:
    """PCA -> its first 50 components -> t-SNE in 2 or 3 dimensions
    (``mer_tpu``'s ``project_embeddings``; perplexity min(30, max(5, N / 10)));
    the projection as float32 numpy."""
    if kind not in ("2D", "3D"):
        raise ValueError("Visualization type not supported")
    x = pca(_f64(embeddings, device).float().double(), device=device)[:, :50]  # the float32 data mer_tpu passes
    z, _ = tsne(x, n_components=3 if kind == "3D" else 2, perplexity=min(30.0, max(5.0, x.shape[0] / 10)))
    return z.float().cpu().numpy()


def silhouette(embeddings, labels, device=None) -> float:
    """The mean silhouette on the raw embeddings (scikit-learn's
    ``silhouette_score``, euclidean); 0.0 for fewer than two classes."""
    labels = np.asarray(labels).reshape(-1)
    classes, codes = np.unique(labels, return_inverse=True)
    if len(classes) < 2:
        return 0.0
    if len(classes) > len(labels) - 1:
        raise ValueError(f"Number of labels is {len(classes)}. Valid values are 2 to n_samples - 1 (inclusive)")
    x = _f64(embeddings, device)
    dist = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    onehot = torch.nn.functional.one_hot(torch.as_tensor(codes, device=x.device), len(classes)).double()
    sums = dist @ onehot  # [N, C] distance sums to each class
    counts = onehot.sum(0)
    own = onehot.bool()
    intra = sums[own] / (counts[codes] - 1).clamp_min(1)
    mean_other = (sums / counts).masked_fill(own, math.inf)
    inter = mean_other.min(1).values
    s = (inter - intra) / torch.maximum(intra, inter)
    s = torch.where(counts[codes] > 1, s, torch.zeros_like(s))
    return float(torch.nan_to_num(s).mean())


# -- scatters ---------------------------------------------------------------------


def _rgb(hex_color: str) -> np.ndarray:
    return np.array([int(hex_color[i:i + 2], 16) for i in (1, 3, 5)], np.float64)


def disc_colour(label: int) -> tuple[int, int, int]:
    """The RGB of a lone disc of class ``label`` over the white background."""
    c = ALPHA * _rgb(PALETTE[int(label) % len(PALETTE)]) + (1 - ALPHA) * 255.0
    return tuple(int(v) for v in np.round(c))


def screen_points(z: np.ndarray) -> np.ndarray:
    """[N, 3] (x, y, depth) canvas coordinates of the HTML page's initial
    view: points rounded to 3 decimals, centred and scaled by the largest
    span to [-1, 1], in 3D rotated by ry 0.6 then rx -0.5 and put in
    perspective 2.2 / (2.2 - 0.55 z), at scale 330 about the centre."""
    pts = np.round(np.asarray(z, dtype=np.float32), 3).astype(np.float64)
    mins, maxs = pts.min(0), pts.max(0)
    span = float((maxs - mins).max()) or 1.0
    p = (pts - (mins + maxs) / 2) / span * 2
    x, y = p[:, 0], p[:, 1]
    depth = p[:, 2] if p.shape[1] == 3 else np.zeros(len(p))
    pers = np.ones(len(p))
    if p.shape[1] == 3:
        c, s = math.cos(0.6), math.sin(0.6)
        x, depth = c * x + s * depth, -s * x + c * depth
        c, s = math.cos(-0.5), math.sin(-0.5)
        y, depth = c * y - s * depth, s * y + c * depth
        pers = 2.2 / (2.2 - depth * 0.55)
    half = CANVAS / 2
    return np.stack([half + x * 330 * pers, half - y * 330 * pers, depth], 1)


def render_scatter(z: np.ndarray, labels: np.ndarray, radius: float = 3.2) -> np.ndarray:
    """[CANVAS, CANVAS, 3] uint8: the scatter's discs, far ones first, each
    blended at :data:`ALPHA` over what lies under it."""
    labels = np.asarray(labels).reshape(-1)
    img = np.full((CANVAS, CANVAS, 3), 255.0)
    pts = screen_points(z)
    order = np.argsort(pts[:, 2], kind="stable")
    r = int(math.ceil(radius))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    for i in order:
        cx, cy = pts[i, 0], pts[i, 1]
        px, py = np.round(cx).astype(int) + dx, np.round(cy).astype(int) + dy
        inside = ((px + 0.5 - cx) ** 2 + (py + 0.5 - cy) ** 2 <= radius ** 2)
        inside &= (px >= 0) & (px < CANVAS) & (py >= 0) & (py < CANVAS)
        ys, xs = py[inside], px[inside]
        colour = _rgb(PALETTE[int(labels[i]) % len(PALETTE)])
        img[ys, xs] = ALPHA * colour + (1 - ALPHA) * img[ys, xs]
    return np.round(img).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` [H, W, 3] uint8 (filter 0 on every row)."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_scatter_png(z: np.ndarray, labels: np.ndarray, path: str, title: str = "") -> str:
    """The static scatter (the reference's ``fig.write_image``); returns the
    path. ``title`` is the HTML page's; the PNG carries no text."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(render_scatter(z, labels)))
    return path


def write_scatter_html(z: np.ndarray, labels: np.ndarray, path: str, title: str = "",
                       label_names: dict[str, int] | None = None) -> str:
    """``mer_tpu``'s dependency-free interactive page: hover shows the class
    name, the wheel zooms, a drag pans (2D) or rotates (3D), a legend maps
    colours to classes."""
    z = np.asarray(z, dtype=np.float32)
    labels = np.asarray(labels).reshape(-1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names = {v: k for k, v in (label_names or {}).items()}
    payload = {
        "dims": int(z.shape[1]),
        "pts": np.round(z, 3).tolist(),
        "labels": labels.astype(int).tolist(),
        "names": [names.get(int(l), str(int(l))) for l in labels],
        "palette": PALETTE,
        "title": title,
    }
    with open(path, "w", encoding="utf-8") as f:
        f.write(_STANDALONE_TEMPLATE.replace("__DATA__", json.dumps(payload)))
    return path


def visualize_embeddings(embeddings, labels, out_dir: str, *, epoch: int = 0, kind: str = "2D", logger=None,
                         label_names: dict[str, int] | None = None, device=None) -> dict:
    """``mer_tpu``'s ``visualize_embeddings``: silhouette, t-SNE projection,
    ``<out_dir>/png/visualization_{epoch}.png`` and
    ``<out_dir>/html/visualization_{epoch}.html``, and the wandb Image / Html
    uploads through ``logger`` (a ``RunLogger``) when it records."""
    sil = silhouette(embeddings, labels, device=device)
    z = project_embeddings(embeddings, kind, device=device)
    title = f"t-SNE ({kind}) — silhouette={sil:.4f}"
    png = write_scatter_png(z, labels, os.path.join(out_dir, "png", f"visualization_{epoch}.png"), title)
    html = write_scatter_html(z, labels, os.path.join(out_dir, "html", f"visualization_{epoch}.html"), title,
                              label_names=label_names)
    if logger is not None:
        logger.log_image("Visualization_png", png)
        logger.log_html("Visualization_html", html)
    return {"silhouette": sil, "tsne": z, "png": png, "html": html}


_STANDALONE_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>embedding visualization</title>
<style>
 body{margin:0;font:13px sans-serif;background:#fff;color:#222}
 #wrap{display:flex}
 canvas{border:1px solid #ddd;margin:12px;cursor:grab}
 #legend{margin:20px 8px}
 .sw{display:inline-block;width:10px;height:10px;margin-right:6px;border-radius:2px}
 #hover{position:fixed;pointer-events:none;background:#222;color:#fff;padding:2px 6px;
        border-radius:3px;display:none;font-size:12px}
 h3{margin:12px 0 0 14px;font-weight:normal}
</style></head><body>
<h3 id="title"></h3>
<div id="wrap"><canvas id="c" width="800" height="800"></canvas><div id="legend"></div></div>
<div id="hover"></div>
<script>
const D = __DATA__;
document.getElementById('title').textContent = D.title;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hover = document.getElementById('hover');
const n = D.pts.length, is3d = D.dims === 3;
// normalize to [-1,1]
let mins=[1e9,1e9,1e9], maxs=[-1e9,-1e9,-1e9];
for (const p of D.pts) for (let k=0;k<D.dims;k++){mins[k]=Math.min(mins[k],p[k]);maxs[k]=Math.max(maxs[k],p[k]);}
const span = Math.max(...maxs.map((m,k)=>m-mins[k])) || 1;
const P = D.pts.map(p => p.map((v,k)=>((v-(mins[k]+maxs[k])/2)/span)*2));
let scale=330, ox=0, oy=0, rx=-0.5, ry=0.6;   // zoom, pan, rotation
let screen = new Array(n);
function proj(p){
  let x=p[0], y=p[1], z=is3d?p[2]:0;
  if (is3d){
    let c=Math.cos(ry), s=Math.sin(ry); [x,z]=[c*x+s*z, -s*x+c*z];
    c=Math.cos(rx); s=Math.sin(rx);    [y,z]=[c*y-s*z,  s*y+c*z];
  }
  const pers = is3d ? 2.2/(2.2 - z*0.55) : 1;
  return [400+(x*scale*pers)+ox, 400-(y*scale*pers)+oy, z];
}
function draw(){
  ctx.clearRect(0,0,800,800);
  const order=[...P.keys()];
  if (is3d) order.sort((a,b)=>proj(P[a])[2]-proj(P[b])[2]);
  for (const i of order){
    const s=proj(P[i]); screen[i]=s;
    ctx.fillStyle = D.palette[D.labels[i] % D.palette.length] + 'b3';
    ctx.beginPath(); ctx.arc(s[0],s[1],3.2,0,6.283); ctx.fill();
  }
}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY];cv.style.cursor='grabbing';};
window.onmouseup=()=>{drag=null;cv.style.cursor='grab';};
window.onmousemove=e=>{
  if (drag){
    const dx=e.clientX-drag[0], dy=e.clientY-drag[1]; drag=[e.clientX,e.clientY];
    if (is3d){ ry+=dx*0.008; rx+=dy*0.008; } else { ox+=dx; oy+=dy; }
    draw(); return;
  }
  const r=cv.getBoundingClientRect(), mx=e.clientX-r.left, my=e.clientY-r.top;
  let best=-1, bd=64;
  for (let i=0;i<n;i++){const s=screen[i]; if(!s)continue;
    const d=(s[0]-mx)**2+(s[1]-my)**2; if (d<bd){bd=d;best=i;}}
  if (best>=0){
    hover.style.display='block'; hover.style.left=(e.clientX+12)+'px';
    hover.style.top=(e.clientY+12)+'px'; hover.textContent=D.names[best];
  } else hover.style.display='none';
};
cv.onwheel=e=>{e.preventDefault(); scale*=e.deltaY<0?1.12:0.89; draw();};
// legend
const seen=new Map();
D.labels.forEach((l,i)=>{if(!seen.has(l))seen.set(l,D.names[i]);});
const lg=document.getElementById('legend');
[...seen.entries()].sort((a,b)=>a[0]-b[0]).forEach(([l,nm])=>{
  const d=document.createElement('div');
  d.innerHTML=`<span class="sw" style="background:${D.palette[l%D.palette.length]}"></span>${nm}`;
  lg.appendChild(d);
});
draw();
</script></body></html>
"""
