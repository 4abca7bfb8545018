"""Frozen copy of ``letf_tpu_torch/ops/joint.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Joint SPY/QQQ/TLT + VIX + IRX generation (kernel K1).

Port of ``letf_tpu/ops/pallas_joint.py::_joint_kernel`` (entry
``pallas_joint_generate``): per trial and day, six Box-Muller normals from
the murmur3 counter RNG keyed by (seed words, base trial id, day, draw
index); the regime-conditional multivariate-t with the chi-square
log-quantile Chebyshev; per-asset GARCH(1,1); DCC-lite Q; closed-form 3x3
Cholesky; VIX AR(1) with jumps; IRX. Day 0 keeps the reference's traced
``firstf`` blend form. Antithetic signs negate the joint normals only.

Layout ``[T, B]``, trials contiguous. ``joint_generate`` launches the CUDA
kernel (``csrc/joint.cu``) for CUDA tensors and runs ``joint_plain`` for
CPU tensors; ``joint_plain`` is also the reference the card's kernel is
held against.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import precision
from benchmark.reference import rng


_TWO_PI = 2.0 * math.pi
(MU0, MU1, MU2, LV0, LV1, LV2, ALPHA, BETA, DCC_A, DCC_B, NU,
 RB00, RB01, RB02, RB11, RB12, RB22,
 VPHI, VTGT, VNOISE, VJTHR, VJSCL, VBASE, DSTD, IRXB) = range(25)


def box_muller(us):
    """Pairs of uniforms -> normals (rad*cos, rad*sin per pair)."""
    out = []
    for p in range(len(us) // 2):
        rad = torch.sqrt(-2.0 * torch.log(us[2 * p]))
        ang = _TWO_PI * us[2 * p + 1]
        out.append(rad * torch.cos(ang))
        out.append(rad * torch.sin(ang))
    return out


def six_normals(day_key: torch.Tensor):
    """Six standard normals per (day, trial) from draw indices 1..6
    (pallas_joint._six_normals)."""
    return box_muller([rng.bits_to_unit(rng.stream_bits(day_key, i + 1))
                       for i in range(6)])


def joint_plain(params, cheb, regime, ids, signs, seed_words):
    """Plain PyTorch K1. params [25, 2] f32; cheb [2, K] f32; regime [T, B]
    f32 0/1; ids [B] int; signs [B] f32 +-1; seed_words two ints.
    Returns (x0, x1, x2, vix, irx), each [T, B] f32."""
    T, B = regime.shape
    dev = regime.device
    lane_key = rng.lane_keys(ids, seed_words)
    dkeys = rng.day_keys(lane_key, torch.arange(T, device=dev), seed_words)
    draws = [d.to(precision.F) for d in six_normals(dkeys)]
    del dkeys
    for c in range(3):
        draws[c] = draws[c] * signs[None, :]
    e0s, e1s, e2s, zcs, vns, irxns = draws

    a = params[:, 0]
    d = params[:, 1] - params[:, 0]
    ca = cheb[0]
    cd = cheb[1] - cheb[0]
    n_cheb = cheb.shape[1]
    outs = [torch.empty((T, B), dtype=precision.F, device=dev)
            for _ in range(5)]
    zero = torch.zeros(B, dtype=precision.F, device=dev)
    (h0, h1, h2, q00, q01, q02, q11, q12, q22,
     z0, z1, z2, prev_r, vixp) = [zero] * 14

    for t in range(T):
        r = regime[t]

        def g2(i):
            return a[i] + d[i] * r

        e0, e1, e2 = e0s[t], e1s[t], e2s[t]
        zc, vn, irxn = zcs[t], vns[t], irxns[t]
        firstf = 1.0 if t == 0 else 0.0
        lv0, lv1, lv2 = g2(LV0), g2(LV1), g2(LV2)
        rb00, rb01, rb02 = g2(RB00), g2(RB01), g2(RB02)
        rb11, rb12, rb22 = g2(RB11), g2(RB12), g2(RB22)
        switch = torch.abs(r - prev_r) * (1.0 - firstf)

        def sel3(lv, garch, h):
            blend = 0.10 * lv + 0.90 * h
            v = garch + switch * (blend - garch)
            return lv * firstf + v * (1.0 - firstf)

        alpha, beta = g2(ALPHA), g2(BETA)
        one_ab = 1.0 - alpha - beta
        g0 = torch.clamp_min(one_ab * lv0 + alpha * z0 * z0 * h0
                             + beta * h0, 1e-10)
        g1 = torch.clamp_min(one_ab * lv1 + alpha * z1 * z1 * h1
                             + beta * h1, 1e-10)
        g2_ = torch.clamp_min(one_ab * lv2 + alpha * z2 * z2 * h2
                              + beta * h2, 1e-10)
        h0n, h1n, h2n = sel3(lv0, g0, h0), sel3(lv1, g1, h1), \
            sel3(lv2, g2_, h2)

        ad, bd = g2(DCC_A), g2(DCC_B)
        one_abd = 1.0 - ad - bd

        def qsel(rb, q, zz):
            dcc = one_abd * rb + ad * zz + bd * q
            blend = 0.10 * rb + 0.90 * q
            v = dcc + switch * (blend - dcc)
            return rb * firstf + v * (1.0 - firstf)

        q00n = qsel(rb00, q00, z0 * z0)
        q01n = qsel(rb01, q01, z0 * z1)
        q02n = qsel(rb02, q02, z0 * z2)
        q11n = qsel(rb11, q11, z1 * z1)
        q12n = qsel(rb12, q12, z1 * z2)
        q22n = qsel(rb22, q22, z2 * z2)

        d0 = torch.sqrt(torch.clamp_min(q00n, 1e-12))
        d1 = torch.sqrt(torch.clamp_min(q11n, 1e-12))
        d2 = torch.sqrt(torch.clamp_min(q22n, 1e-12))
        s0_, s1_, s2_ = torch.sqrt(h0n), torch.sqrt(h1n), torch.sqrt(h2n)
        c00 = (q00n / (d0 * d0)) * s0_ * s0_
        c01 = (q01n / (d0 * d1)) * s0_ * s1_
        c02 = (q02n / (d0 * d2)) * s0_ * s2_
        c11 = (q11n / (d1 * d1)) * s1_ * s1_
        c12 = (q12n / (d1 * d2)) * s1_ * s2_
        c22 = (q22n / (d2 * d2)) * s2_ * s2_

        epsv = 1e-18
        l00 = torch.sqrt(torch.clamp_min(c00, epsv))
        l10 = c01 / l00
        l20 = c02 / l00
        l11 = torch.sqrt(torch.clamp_min(c11 - l10 * l10, epsv))
        l21 = (c12 - l20 * l10) / l11
        l22 = torch.sqrt(torch.clamp_min(c22 - l20 * l20 - l21 * l21, epsv))
        zz0 = l00 * e0
        zz1 = l10 * e0 + l11 * e1
        zz2 = l20 * e0 + l21 * e1 + l22 * e2

        tc = torch.clamp(zc * (1.0 / 6.3), -1.0, 1.0)
        b1 = torch.zeros_like(tc)
        b2 = torch.zeros_like(tc)
        for k in range(n_cheb - 1, 0, -1):
            ck = ca[k] + cd[k] * r
            b1, b2 = ck + 2.0 * tc * b1 - b2, b1
        c0k = ca[0] + cd[0] * r
        u_chi = torch.exp(c0k + tc * b1 - b2)

        scale = torch.sqrt(g2(NU) / torch.clamp_min(u_chi, 1e-12))
        mu0, mu1, mu2 = g2(MU0), g2(MU1), g2(MU2)
        x0 = torch.clamp(mu0 + zz0 * scale, -0.95, 4.0)
        x1 = torch.clamp(mu1 + zz1 * scale, -0.95, 4.0)
        x2 = torch.clamp(mu2 + zz2 * scale, -0.95, 4.0)
        z0 = (x0 - mu0) / torch.sqrt(torch.clamp_min(h0n, 1e-10))
        z1 = (x1 - mu1) / torch.sqrt(torch.clamp_min(h1n, 1e-10))
        z2 = (x2 - mu2) / torch.sqrt(torch.clamp_min(h2n, 1e-10))

        shock = torch.clamp_min(-x0, 0.0) / torch.clamp_min(g2(DSTD), 1e-4)
        vjump = g2(VJSCL) * torch.clamp_min(shock - g2(VJTHR), 0.0)
        phi = g2(VPHI)
        vix_ar = torch.clamp_min(
            phi * vixp + (1.0 - phi) * g2(VTGT) + vjump + g2(VNOISE) * vn,
            10.0)
        vix_t = g2(VBASE) * firstf + vix_ar * (1.0 - firstf)
        irx_t = torch.clamp(g2(IRXB) + 0.5 * irxn, 0.0, 15.0)

        for o, v in zip(outs, (x0, x1, x2, vix_t, irx_t)):
            o[t] = v
        h0, h1, h2 = h0n, h1n, h2n
        q00, q01, q02, q11, q12, q22 = q00n, q01n, q02n, q11n, q12n, q22n
        prev_r, vixp = r, vix_t
    return tuple(outs)


# The plain version stands wherever the port dispatches to its kernel.
joint_generate = joint_plain
