"""Plain PyTorch reference of FLOAT's forward pass, the yardstick that
decides ``correct``.

It follows the published model (arXiv:2412.01064; the reference plugin's
``FLOAT.py``, ``styledecoder.py``, ``FMT.py`` and HF's wav2vec2) in
float32 with TF32 off, on whatever device its inputs are on: image
encoder, wav2vec2-base audio encoder and projection, wav2vec2-large SER,
the chunked CFG-ODE sampler (Euler) and the flow-warping StyleGAN2
decoder, whose warps are ``F.grid_sample`` (bilinear, zero padding,
``align_corners=False``).  It imports nothing of the program under test
and reads nothing that the program made: the harness hands it the seeded
weights and inputs it hands the program.

``Precision(control=True)`` is the control of the comparison: the same
reference one step below the precision the configuration states, TF32
for the float32 stages and float8 (e4m3, one scale a tensor) for the
operands of the bfloat16 decode's convolutions.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
FP8_MAX = 448.0


class Precision:
    """float32 with TF32 off (the reference), or the control."""

    def __init__(self, control: bool = False):
        self.control = control

    @contextlib.contextmanager
    def matmuls(self):
        """TF32 off for the reference, on for the control."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.control
        torch.backends.cudnn.allow_tf32 = self.control
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def dq(self, x: torch.Tensor) -> torch.Tensor:
        """A decode operand as computed: itself, or rounded to float8."""
        if not self.control:
            return x
        s = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s


F32 = Precision()


# ----------------------------------------------------------------------
# StyleGAN2 pieces
# ----------------------------------------------------------------------

def lrelu(x, bias=None):
    """leaky_relu(x + bias, 0.2) * sqrt(2); bias over dim 1 of NCHW."""
    if bias is not None:
        x = x + (bias.reshape(1, -1, 1, 1) if x.ndim == 4 else bias)
    return F.leaky_relu(x, 0.2) * SQRT2


def blur_kernel(factor: int = 1, device=None) -> torch.Tensor:
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    k = torch.outer(k, k)
    return k / k.sum() * factor ** 2


def upfirdn(x, k, up=1, down=1, pad=(0, 0)):
    """Zero-insert ``up``, pad (negative crops), correlate with the flipped
    FIR kernel, keep every ``down``-th pixel."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up,
                                                           w * up)
    p0, p1 = pad
    x = F.pad(x, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    lo, hi = max(-p0, 0), max(-p1, 0)
    x = x[:, :, lo:x.shape[2] - hi, lo:x.shape[3] - hi]
    kk = torch.flip(k, (0, 1))[None, None].expand(c, 1, *k.shape)
    return F.conv2d(x, kk.to(x.dtype), stride=down, groups=c)


def eq_conv(x, w, bias=None, stride=1, padding=0):
    o, i, kh, kw = w.shape
    return F.conv2d(x, w / math.sqrt(i * kh * kw), bias, stride, padding)


def eq_linear(x, w, b):
    return F.linear(x, w / math.sqrt(w.shape[1]), b)


# ----------------------------------------------------------------------
# image encoder
# ----------------------------------------------------------------------

def _enc_layer(x, p, k, down, act=True):
    if down:
        pl = 2 + (k - 1)
        x = upfirdn(x, blur_kernel(device=x.device),
                    pad=((pl + 1) // 2, pl // 2))
        conv, stride, pad = p["1"], 2, 0
    else:
        conv, stride, pad = p["0"], 1, k // 2
    x = eq_conv(x, conv["weight"], None if act else conv.get("bias"),
                stride, pad)
    if act:
        x = lrelu(x, p["2" if down else "1"]["bias"].reshape(-1))
    return x


def encode_image(p, img, size):
    """(1, 3, S, S) -> s_r (1, 512), r_s_lambda (1, dim_m), feats
    (coarse-first skip maps 8² … S²)."""
    convs = p["net_app"]["convs"]
    res = []
    h = _enc_layer(img, convs["0"], 1, False)
    res.append(h)
    n = int(math.log2(size)) - 2
    for i in range(n):
        q = convs[str(i + 1)]
        out = _enc_layer(h, q["conv1"], 3, False)
        out = _enc_layer(out, q["conv2"], 3, True)
        skip = _enc_layer(h, q["skip"], 1, True, act=False)
        h = (out + skip) / SQRT2
        res.append(h)
    h = eq_conv(h, convs[str(n + 1)]["weight"])
    res.append(h)
    s_r = h.reshape(1, -1)
    lam = s_r
    for i in range(5):
        lam = eq_linear(lam, p["fc"][str(i)]["weight"],
                        p["fc"][str(i)]["bias"])
    return s_r, lam, res[::-1][2:]


def direction(p, lam):
    """lam @ Q.T, Q the QR basis of the direction weight (LAPACK on the
    CPU, as the reference's torch.linalg.qr)."""
    q, _ = torch.linalg.qr(p["weight"].detach().float().cpu() + 1e-8)
    return lam @ q.to(lam.device).t()


# ----------------------------------------------------------------------
# wav2vec2 (HF layout)
# ----------------------------------------------------------------------

def _lin(p, x):
    return F.linear(x, p["weight"], p["bias"])


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _conv_features(p, wave, c):
    x = wave[:, None, :]
    for i, s in enumerate(c["conv_stride"]):
        q = p["conv_layers"][str(i)]
        x = F.conv1d(x, q["conv"]["weight"], q["conv"].get("bias"), stride=s)
        if c["feat_extract_norm"] == "group" and i == 0:
            x = F.group_norm(x, x.shape[1], q["layer_norm"]["weight"],
                             q["layer_norm"]["bias"], 1e-5)
        elif c["feat_extract_norm"] == "layer":
            x = _ln(q["layer_norm"], x.transpose(1, 2)).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _attention(p, x, heads):
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_lin(p[n], x).reshape(b, t, heads, hd).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    a = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), -1)
    return _lin(p["out_proj"], (a @ v).transpose(1, 2).reshape(b, t, d))


def _ffn(p, x):
    return _lin(p["output_dense"], F.gelu(_lin(p["intermediate_dense"], x)))


def _w2v_encoder(p, x, c):
    """Projected features -> hidden states [input of layer 1, …, last]."""
    k = c["num_conv_pos_embeddings"]
    pos = F.conv1d(x.transpose(1, 2), p["pos_conv_embed"]["conv"]["weight"],
                   p["pos_conv_embed"]["conv"]["bias"], padding=k // 2,
                   groups=c["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    heads = c["num_attention_heads"]
    hidden = []
    if c["do_stable_layer_norm"]:
        for i in range(c["num_hidden_layers"]):
            hidden.append(x)
            q = p["layers"][str(i)]
            x = x + _attention(q["attention"], _ln(q["layer_norm"], x), heads)
            x = x + _ffn(q["feed_forward"], _ln(q["final_layer_norm"], x))
        x = _ln(p["layer_norm"], x)
    else:
        x = _ln(p["layer_norm"], x)
        for i in range(c["num_hidden_layers"]):
            hidden.append(x)
            q = p["layers"][str(i)]
            x = _ln(q["layer_norm"], x + _attention(q["attention"], x, heads))
            x = _ln(q["final_layer_norm"], x + _ffn(q["feed_forward"], x))
    hidden.append(x)
    return hidden


def _project(p, feats):
    fp = p["feature_projection"]
    return _lin(fp["projection"], _ln(fp["layer_norm"], feats))


def _resample_time(x, n):
    """Linear resampling of (B, T, D) to n steps, align_corners=True."""
    return F.interpolate(x.transpose(1, 2), size=n, mode="linear",
                         align_corners=True).transpose(1, 2)


def encode_audio(p, wave, n_frames, fc, wc):
    """wave (1, N) -> wa (1, T, dim_w): edge-padded to T frames of
    samples, conv features resampled to T, the stacked layer outputs
    projected (Linear, LayerNorm, SiLU)."""
    target = int(n_frames * fc["sampling_rate"] / fc["fps"])
    if wave.shape[1] < target:
        wave = F.pad(wave[:, None], (0, target - wave.shape[1]),
                     mode="replicate")[:, 0]
    w2v = p["wav2vec2"]
    feats = _resample_time(_conv_features(w2v["feature_extractor"], wave,
                                          wc), n_frames)
    hidden = _w2v_encoder(w2v["encoder"], _project(w2v, feats), wc)
    stacked = hidden[-1] if fc["only_last_features"] else torch.cat(
        hidden[1:], -1)
    proj = p["audio_projection"]
    return F.silu(_ln(proj["1"], _lin(proj["0"], stacked)))


def emotion(p, wave, sc):
    """SER scores from the whole wave -> we (1, 1, E)."""
    h = _w2v_encoder(p["encoder"],
                     _project(p, _conv_features(p["feature_extractor"], wave,
                                                sc)), sc)[-1]
    x = torch.tanh(_lin(p["classifier"]["dense"], h.mean(1)))
    return torch.softmax(_lin(p["classifier"]["out_proj"], x), -1)[:, None]


# ----------------------------------------------------------------------
# FMT and the sampler
# ----------------------------------------------------------------------

def _sinusoid(n, d, device):
    pos = np.arange(n)[:, None]
    idx = np.arange(d)[None, :]
    ang = pos / np.power(10000.0, 2 * (idx // 2) / d)
    ang[:, 0::2] = np.sin(ang[:, 0::2])
    ang[:, 1::2] = np.cos(ang[:, 1::2])
    return torch.from_numpy(ang.astype(np.float32)).to(device)


def _band_bias(n, w, device):
    i = torch.arange(n, device=device)
    inside = (i[None, :] >= i[:, None] - w) & (i[None, :] <= i[:, None] + w)
    return torch.where(inside, 0.0, -1e9)


def _t_embed(p, t, device):
    half = 128
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    args = t.reshape(1, 1) * freqs[None]
    e = torch.cat([torch.cos(args), torch.sin(args)], -1)
    return _lin(p["mlp"]["2"], F.silu(_lin(p["mlp"]["0"], e)))


def _norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def fmt(p, t, x, wa, wr, we, prev_x, prev_wa, fc):
    """The velocity (B, L'+L, dim_w); we (B, 1, E) static."""
    x = torch.cat([prev_x, x], 1)
    wa = torch.cat([prev_wa, wa], 1)
    b, n, _ = x.shape
    h = _lin(p["x_embedder"]["proj"], x)
    h = h + _sinusoid(n, h.shape[-1], x.device)[None]
    c = _lin(p["c_embedder"], torch.cat(
        [wr[:, None].expand(b, n, -1), wa, we.expand(b, n, -1)], -1))
    c = c + _t_embed(p["t_embedder"], t, x.device)[:, None]
    bias = _band_bias(n, fc["attention_window"], x.device)
    heads = fc["num_heads"]
    d = h.shape[-1]
    hd = d // heads
    for i in range(fc["fmt_depth"]):
        q = p["blocks"][str(i)]
        sm, cm, gm, sf, cf, gf = _lin(q["adaLN_modulation"]["1"],
                                      F.silu(c)).chunk(6, -1)
        y = _norm(h) * (1 + cm) + sm
        qkv = _lin(q["attn"]["qkv"], y).reshape(b, n, 3, heads, hd)
        qq, kk, vv = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = torch.softmax(qq @ kk.transpose(-1, -2) / math.sqrt(hd) + bias,
                          -1)
        h = h + gm * _lin(q["attn"]["proj"],
                          (a @ vv).transpose(1, 2).reshape(b, n, d))
        y = _norm(h) * (1 + cf) + sf
        h = h + gf * _lin(q["mlp"]["fc2"], F.gelu(
            _lin(q["mlp"]["fc1"], y), approximate="tanh"))
    sh, sc = _lin(p["decoder"]["adaLN_modulation"]["1"],
                  F.silu(c)).chunk(2, -1)
    return _lin(p["decoder"]["linear"], _norm(h) * (1 + sc) + sh)


def sample(p, r_s, wa, we, seed, fc):
    """r_d (1, T, dim_w): chunks of ``num_frames_for_clip``, each from
    N(0, I) noise drawn chunk after chunk from a ``torch.Generator`` on
    wa's device seeded with ``seed``, integrated over
    linspace(0, 1, nfe) by Euler steps of the 3-way CFG field
    uncond + a (audio - uncond) + e (all - audio); the carry is the last
    ``num_prev_frames`` of motion and audio."""
    if fc["ode_method"] != "euler" or fc["include_r_cfg"]:
        raise ValueError("the reference samples with Euler and 3-way CFG")
    clip, prev = int(fc["wav2vec_sec"] * fc["fps"]), fc["num_prev_frames"]
    t = wa.shape[1]
    n_chunks = math.ceil(t / clip)
    pad = n_chunks * clip - t
    wa_p = torch.cat([wa, wa[:, -1:].expand(1, pad, -1)], 1) if pad else wa
    dev = wa.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    prev_x = torch.zeros(1, prev, fc["dim_w"], device=dev)
    prev_wa = torch.zeros(1, prev, fc["dim_w"], device=dev)
    a_s, e_s = fc["a_cfg_scale"], fc["e_cfg_scale"]
    z = torch.zeros_like
    ts = torch.linspace(0.0, 1.0, fc["nfe"], device=dev)
    out = []
    for ci in range(n_chunks):
        x = torch.randn((1, clip, fc["dim_w"]), generator=gen, device=dev)
        wa_c = wa_p[:, ci * clip:(ci + 1) * clip]
        for k in range(fc["nfe"] - 1):
            v = fmt(p, ts[k], torch.cat([x] * 3),
                    torch.cat([z(wa_c), wa_c, wa_c]), torch.cat([r_s] * 3),
                    torch.cat([z(we), we, z(we)]), torch.cat([prev_x] * 3),
                    torch.cat([prev_wa] * 3), fc)[:, prev:]
            un, al, au = v.chunk(3)
            x = x + (ts[k + 1] - ts[k]) * (un + a_s * (au - un)
                                           + e_s * (al - au))
        out.append(x)
        prev_x, prev_wa = x[:, -prev:], wa_c[:, -prev:]
    return torch.cat(out, 1)[:, :t]


# ----------------------------------------------------------------------
# the flow-warping decoder
# ----------------------------------------------------------------------

def _modconv(x, style, p, prec, demod=True, up=False):
    """StyleGAN2's modulated conv of ``p`` ({weight (1, O, I, k, k),
    modulation}): input scaled by the style, output by the demodulation;
    ``up`` a stride-2 transposed conv and the FIR blur."""
    w = p["weight"][0]
    mod = p["modulation"]
    o, i, kh, kw = w.shape
    scale = 1.0 / math.sqrt(i * kh * kw)
    s = eq_linear(style, mod["weight"], mod["bias"])            # (B, I)
    xm = prec.dq(x * (s * scale)[:, :, None, None])
    wq = prec.dq(w)
    if up:
        out = F.conv_transpose2d(xm, wq.transpose(0, 1), stride=2)
    else:
        out = F.conv2d(xm, wq, padding=kh // 2)
    if demod:
        d = torch.rsqrt((s ** 2) @ ((w * scale) ** 2).sum((2, 3)).t() + 1e-8)
        out = out * d[:, :, None, None]
    if up:
        pl = 2 - (kh - 1)
        out = upfirdn(out, blur_kernel(2, x.device),
                      pad=((pl + 1) // 2 + 1, pl // 2 + 1))
    return out


def _up2(x):
    return upfirdn(x, blur_kernel(2, x.device), up=2, pad=(2, 1))


def _identity_grid(n, device):
    xs = torch.linspace(-1.0, 1.0, n, device=device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def synthesize(p, wa, feats, size, prec=F32):
    """wa (B, 512) per frame, feats shared by the frames -> images
    (B, 3, S, S) in about [-1, 1]."""
    b = wa.shape[0]
    x = p["input"]["input"].expand(b, -1, -1, -1)
    x = lrelu(_modconv(x, wa, p["conv1"]["conv"], prec),
              p["conv1"]["activate"]["bias"].reshape(-1))
    skip = skip_flow = None
    for lvl in range(int(math.log2(size)) - 2):
        for j, up in ((2 * lvl, True), (2 * lvl + 1, False)):
            q = p["convs"][str(j)]
            x = lrelu(_modconv(x, wa, q["conv"], prec, up=up),
                      q["activate"]["bias"].reshape(-1))
        pf = p["to_flows"][str(lvl)]
        out = _modconv(x, wa, pf["conv"], prec, demod=False)
        out = out + pf["bias"].reshape(1, 3, 1, 1)
        if skip_flow is not None:
            out = out + _up2(skip_flow)
        skip_flow = out
        grid = torch.tanh(out[:, :2]).permute(0, 2, 3, 1) + _identity_grid(
            x.shape[2], x.device)
        mask = torch.sigmoid(out[:, 2:3])
        feat = prec.dq(feats[lvl]).expand(b, -1, -1, -1)
        warped = F.grid_sample(feat, grid, mode="bilinear",
                               padding_mode="zeros", align_corners=False)
        feat_warp = warped * mask
        x = feat_warp + x * (1.0 - mask)
        pr = p["to_rgbs"][str(lvl)]
        rgb = eq_conv(prec.dq(feat_warp), prec.dq(pr["conv"]["0"]["weight"]))
        rgb = lrelu(rgb, pr["conv"]["1"]["bias"].reshape(-1))
        rgb = rgb + pr["bias"].reshape(1, 3, 1, 1)
        skip = rgb if skip is None else rgb + _up2(skip)
    return skip


def decode(p, s_r, feats, r_d, size, prec=F32, chunk=8):
    """Frames (T, S, S, 3) in [0, 1] of the latents r_d (T, dim_w)."""
    frames = []
    for lo in range(0, r_d.shape[0], chunk):
        img = synthesize(p, s_r + r_d[lo:lo + chunk], feats, size, prec)
        frames.append(((img.clamp(-1.0, 1.0) + 1.0) * 0.5).permute(0, 2, 3,
                                                                   1))
    return torch.cat(frames)


# ----------------------------------------------------------------------
# one request
# ----------------------------------------------------------------------

def generate(params, img, wave, seed, model, prec=F32):
    """(r_d (1, T, dim_w), frames (T, S, S, 3) in [0, 1]) of one request:
    ``params`` the seeded weight tree, ``model`` the configuration file's
    ``float`` / ``wav2vec2`` / ``ser`` sections."""
    fc, wc, sc = model["float"], model["wav2vec2"], model["ser"]
    if model["emotion"] != "none":
        raise ValueError("the reference predicts the emotion from the audio")
    size = fc["input_size"]
    with torch.no_grad(), prec.matmuls():
        s_r, lam, feats = encode_image(params["encoder"], img, size)
        r_s = direction(params["synthesis"]["direction"], lam)
        t = math.ceil(wave.shape[-1] * fc["fps"] / fc["sampling_rate"])
        wa = encode_audio(params["audio_encoder"], wave, t, fc, wc)
        we = emotion(params["emotion"], wave, sc)
        r_d = sample(params["fmt"], r_s, wa, we, seed, fc)
        frames = decode(params["synthesis"], s_r, feats, r_d[0], size, prec)
    return r_d, frames
