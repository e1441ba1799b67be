"""Initial weights of the three networks and the per-frame codes, drawn on
the device in a few large calls, by the published
initialisations: the SDF's geometric sphere init (IDR/SAL, bias 0.6), the
translator's U(+-1/sqrt(in)) with a N(0, 1e-3) last layer and zero bias,
the colour net's U(+-1/sqrt(in)), weight-normalised layers with g the row
norms of v; the deformer and renderer codes as 0.1 * N(0, 1) coefficients
of the first F/5 DCT-II rows over the frames.  Both the program and the
reference start from these tensors.  The SDF's weights come from a
generator of their own: the SDF is fitted to the body in set-up, and a
fixed start gives every run the same fitted surface and so the same
template sizes."""
from __future__ import annotations

import math
from typing import Dict

import torch


def _layers(sd: Dict[str, torch.Tensor], prefix: str):
    """The (out, in) weight shapes of the linear layers lin0.. of a net in
    state-dict order, and whether each is weight-normalised."""
    out, l = [], 0
    while f"{prefix}lin{l}.bias" in sd:
        wn = f"{prefix}lin{l}.weight_v" in sd
        w = sd[f"{prefix}lin{l}.weight_v" if wn else f"{prefix}lin{l}.weight"]
        out.append((l, tuple(w.shape), wn))
        l += 1
    return out


def net_weights(shapes: Dict[str, torch.Tensor], sdf_skip: int,
                sdf_bias: float, sdf_pe_dims: int, sdf_generator, generator,
                device) -> Dict[str, torch.Tensor]:
    """A state dict of the networks with the keys and shapes of `shapes`
    (the port's module names: sdf.*, deformer.defs.0.*, netRender.*); the
    SDF's from sdf_generator, the others' from generator."""
    nets = {p: _layers(shapes, p) for p in
            ("sdf.", "deformer.defs.0.", "netRender.")}
    n_sdf = sum(o * i for o, i in (s for _, s, _ in nets["sdf."]))
    t_last = nets["deformer.defs.0."][-1][1]
    n_unif = sum(o * i + o for p in ("deformer.defs.0.", "netRender.")
                 for _, (o, i), _ in nets[p])
    normal = torch.randn(n_sdf, generator=sdf_generator, device=device)
    t_normal = torch.randn(t_last[0] * t_last[1], generator=generator,
                           device=device)
    unif = torch.rand(n_unif, generator=generator, device=device) * 2 - 1
    sd, a, b = {}, 0, 0

    def put(prefix, l, wn, w, bias):
        if wn:
            sd[f"{prefix}lin{l}.weight_v"] = w
            sd[f"{prefix}lin{l}.weight_g"] = torch.linalg.norm(
                w, dim=1, keepdim=True)
        else:
            sd[f"{prefix}lin{l}.weight"] = w
        sd[f"{prefix}lin{l}.bias"] = bias

    last = len(nets["sdf."]) - 1
    for l, (o, i), wn in nets["sdf."]:
        z = normal[a:a + o * i].reshape(o, i)
        a += o * i
        if l == last:
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * z
            bias = torch.full((o,), -sdf_bias, device=device)
        else:
            w = z * (math.sqrt(2) / math.sqrt(o))
            if l == 0:
                w = torch.cat([w[:, :3], torch.zeros_like(w[:, 3:])], 1)
            elif l == sdf_skip:
                w = torch.cat([w[:, :i - (sdf_pe_dims - 3)],
                               torch.zeros_like(w[:, i - (sdf_pe_dims - 3):])],
                              1)
            bias = torch.zeros(o, device=device)
        put("sdf.", l, wn, w, bias)
    for prefix in ("deformer.defs.0.", "netRender."):
        layers = nets[prefix]
        for l, (o, i), wn in layers:
            bound = 1.0 / math.sqrt(i)
            w = unif[b:b + o * i].reshape(o, i) * bound
            bias = unif[b + o * i:b + o * i + o] * bound
            b += o * i + o
            if prefix == "deformer.defs.0." and l == len(layers) - 1:
                w = 1e-3 * t_normal.reshape(o, i)
                bias = torch.zeros_like(bias)
            put(prefix, l, wn, w, bias)
    return sd


def frame_codes(n_frames: int, lengths: Dict[str, int], generator,
                device) -> Dict[str, torch.Tensor]:
    """Per-frame codes (F, length) for each name in `lengths`: smooth over
    the frames, as 0.1 * N(0, 1) weights of the first F/5 DCT-II rows."""
    k = max(n_frames // 5, 1)
    n = torch.arange(n_frames, dtype=torch.float64, device=device)
    rows = torch.arange(k, dtype=torch.float64, device=device)[:, None]
    basis = torch.cos(math.pi * (n[None] + 0.5) * rows / n_frames)
    basis = basis * math.sqrt(2.0 / n_frames)
    basis[0] = 1.0 / math.sqrt(n_frames)
    out = {}
    for name, length in lengths.items():
        coef = 0.1 * torch.randn(length, k, generator=generator, device=device,
                                 dtype=torch.float64)
        out[name] = (coef @ basis).T.to(torch.float32).contiguous()
    return out
