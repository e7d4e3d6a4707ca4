"""mamba2 — SSD (state-space duality) blocks [arXiv:2405.21060].

Prefill uses the chunked dual form: a loop over sequence chunks carrying
the (B, heads, head_dim, state) SSM state; each chunk does the quadratic
intra-chunk piece (attention-like, O(chunk^2)) plus the low-rank
inter-chunk state pass, and a trailing partial chunk takes the same step at
its own length. Decode is the O(1)-state recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.models.layers import cast_tree, rms_norm, silu, softplus
from repro_torch.models.params import Decl
from repro_torch.models.transformer import DenseLM, maybe_scan


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B,S,D), w: (K,D)."""
    K = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(K):
        shift = K - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[i]
    return out


def _conv_step(ring, xt, w):
    """One-token conv. ring: (B,K-1,D) past inputs; xt: (B,1,D)."""
    window = torch.cat([ring, xt], dim=1)                 # (B,K,D)
    yt = torch.einsum("bkd,kd->bd", window, w.to(window.dtype))[:, None]
    return window[:, 1:], yt


class MambaLM(DenseLM):
    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        s = cfg.ssm
        self.di = s.d_inner(cfg.d_model)
        self.nh = s.n_heads(cfg.d_model)
        self.gn = s.n_groups * s.d_state

    # ------------------------------------------------------------ decls ----
    def layer_decls(self) -> dict:
        cfg = self.cfg
        s = cfg.ssm
        L, d, di, nh, gn = cfg.n_layers, cfg.d_model, self.di, self.nh, self.gn
        return {
            "norm": blocks.norm_decls(cfg, L),
            "wz": Decl((L, d, di)),
            "wx": Decl((L, d, di)),
            "wB": Decl((L, d, gn)),
            "wC": Decl((L, d, gn)),
            "wdt": Decl((L, d, nh)),
            "dt_bias": Decl((L, nh), init="zeros"),
            "A_log": Decl((L, nh), init="small"),
            "D": Decl((L, nh), init="ones"),
            "conv_x": Decl((L, s.conv_width, di), init="small"),
            "conv_B": Decl((L, s.conv_width, gn), init="small"),
            "conv_C": Decl((L, s.conv_width, gn), init="small"),
            "gate_norm": Decl((L, di), init="zeros"),
            "wo": Decl((L, di, d)),
        }

    def cache_decls(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        s = cfg.ssm
        L, cw = cfg.n_layers, s.conv_width
        return {
            "H": Decl((L, batch, self.nh, s.head_dim, s.d_state),
                      init="zeros", dtype="float32"),
            "conv_x": Decl((L, batch, cw - 1, self.di), init="zeros",
                           dtype="float32"),
            "conv_B": Decl((L, batch, cw - 1, self.gn), init="zeros",
                           dtype="float32"),
            "conv_C": Decl((L, batch, cw - 1, self.gn), init="zeros",
                           dtype="float32"),
        }

    # ---------------------------------------------------------- SSD core ---
    def _branches(self, lp, x):
        """Projections + conv + activations for a (B,S,d) slab; also the
        three pre-conv projections (the conv state's source)."""
        z = x @ lp["wz"]
        raw = (x @ lp["wx"], x @ lp["wB"], x @ lp["wC"])
        xr, Br, Cr = (silu(_causal_conv(t, lp[c])) for t, c in
                      zip(raw, ("conv_x", "conv_B", "conv_C")))
        dt = softplus((x @ lp["wdt"]).float() + lp["dt_bias"])
        return z, xr, Br, Cr, dt, raw

    def _ssd(self, lp, xr, Br, Cr, dt, H0):
        """Chunked SSD. xr: (B,S,di); Br/Cr: (B,S,gn); dt: (B,S,nh) fp32.

        Returns (y (B,S,di), H_final (B,nh,hd,N) fp32).
        """
        s = self.cfg.ssm
        B, S, _ = xr.shape
        nh, hd, N, G = self.nh, s.head_dim, s.d_state, s.n_groups
        Q = min(s.chunk, S)
        nc, rem = divmod(S, Q)

        A = -torch.exp(lp["A_log"].float())                      # (nh,) < 0
        head_group = torch.arange(nh, device=xr.device) // (nh // G)

        def chunk_step(H, xb, Bc, Cc, dA):
            """xb (B,Q,nh,hd), Bc/Cc (B,Q,nh,N), dA (B,Q,nh); any Q."""
            Qc = xb.shape[1]
            cum = torch.cumsum(dA, dim=1)                        # (B,Q,nh)
            Lm = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
            tril = torch.tril(torch.ones((Qc, Qc), dtype=torch.bool,
                                         device=xb.device))
            Lm = torch.where(tril[None, :, :, None], Lm, 0.0)
            CB = torch.einsum("bqhn,bphn->bqph", Cc.float(), Bc.float())
            y_diag = torch.einsum("bqph,bphd->bqhd", CB * Lm, xb)
            y_off = torch.einsum("bqhn,bhdn->bqhd",
                                 Cc.float() * torch.exp(cum)[..., None], H)
            decay = torch.exp(cum[:, -1:, :] - cum)              # (B,Q,nh)
            H_new = H * torch.exp(cum[:, -1, :])[:, :, None, None] + \
                torch.einsum("bphn,bphd->bhdn", Bc.float() * decay[..., None], xb)
            return H_new, y_diag + y_off

        def pieces(a, b):
            """Positions [a, b) as (xbar, Bh, Ch, dA) of one chunk."""
            n = b - a
            dtc = dt[:, a:b]
            xh = xr[:, a:b].reshape(B, n, nh, hd)
            Bh = Br[:, a:b].reshape(B, n, G, N)[:, :, head_group]
            Ch = Cr[:, a:b].reshape(B, n, G, N)[:, :, head_group]
            return xh.float() * dtc[..., None], Bh, Ch, dtc * A

        H, ys = H0, []
        for c in range(nc):
            H, yc = chunk_step(H, *pieces(c * Q, (c + 1) * Q))
            ys.append(yc)
        if rem:  # trailing partial chunk (arbitrary sequence lengths)
            H, yc = chunk_step(H, *pieces(nc * Q, S))
            ys.append(yc)
        y = torch.cat(ys, dim=1)
        y = y + xr.float().reshape(B, S, nh, hd) * lp["D"].float()[:, None]
        return y.reshape(B, S, self.di).to(xr.dtype), H

    def _layer_fwd(self, x, lp, pos, collect_kv: bool):
        cfg = self.cfg
        s = cfg.ssm
        h = blocks.norm_apply(cfg, lp["norm"], x)
        z, xr, Br, Cr, dt, raw = self._branches(lp, h)
        H0 = torch.zeros((x.shape[0], self.nh, s.head_dim, s.d_state),
                         dtype=torch.float32, device=x.device)
        y, H = self._ssd(lp, xr, Br, Cr, dt, H0)
        y = rms_norm(y * silu(z), lp["gate_norm"], cfg.norm_eps)
        x = x + y @ lp["wo"]
        ys = None
        if collect_kv:
            cw = s.conv_width
            ys = (H,) + tuple(t[:, -(cw - 1):].float() for t in raw)
        return x, ys

    # ------------------------------------------------------------ prefill --
    def prefill(self, params, batch, capacity=None):
        """capacity ignored: the SSM/conv state is O(1) in sequence length."""
        x, pos, _ = self.embed_inputs(params, batch)
        x, ys = self.backbone(params, x, pos, collect_kv=True)
        logits = blocks.logits_out(self.cfg, params, x[:, -1:])
        cache = {"H": ys[0], "conv_x": ys[1], "conv_B": ys[2], "conv_C": ys[3]}
        return cache, logits

    # ------------------------------------------------------------- decode --
    def decode(self, params, cache, token, pos):
        cfg = self.cfg
        s = cfg.ssm
        x = blocks.embed_tokens(params, token, cfg.dtype)    # (B,1,d)
        lp_all = cast_tree(params["layers"], cfg.dtype)
        head_group = torch.arange(self.nh, device=x.device) // (
            self.nh // s.n_groups)

        def body(x, xs):
            lp, H, rx, rB, rC = xs
            h = blocks.norm_apply(cfg, lp["norm"], x)
            z = h @ lp["wz"]
            rx_new, xr = _conv_step(rx, (h @ lp["wx"]).float(), lp["conv_x"])
            rB_new, Br = _conv_step(rB, (h @ lp["wB"]).float(), lp["conv_B"])
            rC_new, Cr = _conv_step(rC, (h @ lp["wC"]).float(), lp["conv_C"])
            xr, Br, Cr = silu(xr), silu(Br), silu(Cr)
            dt = softplus((h @ lp["wdt"]).float() + lp["dt_bias"])[:, 0]  # (B,nh)
            A = -torch.exp(lp["A_log"].float())
            Bh = Br[:, 0].reshape(-1, s.n_groups, s.d_state)[:, head_group]
            Ch = Cr[:, 0].reshape(-1, s.n_groups, s.d_state)[:, head_group]
            xh = xr[:, 0].reshape(-1, self.nh, s.head_dim)
            dA = torch.exp(dt * A)                            # (B,nh)
            H_new = H * dA[..., None, None] + torch.einsum(
                "bhn,bhd,bh->bhdn", Bh, xh, dt)
            y = torch.einsum("bhn,bhdn->bhd", Ch, H_new) + xh * lp["D"][:, None]
            y = y.reshape(-1, 1, self.di).to(x.dtype)
            y = rms_norm(y * silu(z), lp["gate_norm"], cfg.norm_eps)
            # the state in place (the reference's serving step donates it)
            H.copy_(H_new), rx.copy_(rx_new), rB.copy_(rB_new), rC.copy_(rC_new)
            return x + y @ lp["wo"], None

        x, _ = maybe_scan(body, x, (lp_all, cache["H"], cache["conv_x"],
                                    cache["conv_B"], cache["conv_C"]),
                          collect=False)
        x = blocks.norm_apply(cfg, params["final_norm"], x)
        return cache, blocks.logits_out(cfg, params, x)
