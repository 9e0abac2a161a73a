"""The v1 RNN attention zoo (port of espnet_tpu/models/rnn_attentions.py).

Fourteen attentions of the reference `espnet/nets/pytorch_backend/rnn/
attentions.py` and the factory `make_attention` (`initial_att`). As in the
JAX package each is a stateless module with an explicit fixed-shape dict
state, every leaf with a leading batch axis so that a beam search reorders
hypotheses with one gather per leaf:

    init_state(batch, t_max, enc_mask) -> dict
    forward(enc, enc_mask, dec_state, state, out_prev=None)
        -> (context, weights, new_state)

AttCov and AttCovLoc keep a running coverage sum and AttLoc2D a rolling
window of its last `att_win` alignments (the JAX formulations); the biases
that cancel in the softmax (`gvec`'s) are left out. torch needs the input
widths that flax infers: `enc_dim` (the encoder's, eprojs), `dec_dim` (the
decoder state's, dunits) and, for AttForwardTA, `out_prev_dim`. The
location convolutions are `2 * (conv_kernel // 2) + 1` wide, odd, so
"SAME" padding is symmetric; flax's kernels (W, in, out) and (H, W, in,
out) are torch's (out, in, W) and (out, in, H, W) (`convert.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from espnet_tpu_torch.models.layers import Conv1d, Dense

ATT_TYPES = (
    "noatt", "dot", "add", "location", "coverage", "coverage_location",
    "location2d", "location_recurrent", "multi_head_dot", "multi_head_add",
    "multi_head_loc", "multi_head_multi_res_loc", "forward", "forward_ta",
)


def _uniform_valid(enc_mask, dtype):
    """Uniform weights over the valid frames (the reference's first
    alignment)."""
    m = enc_mask.to(dtype)
    return m / m.sum(dim=-1, keepdim=True)


def _masked_softmax(e, enc_mask, scaling):
    e = torch.where(enc_mask, e, torch.full_like(e, -1e30))
    return torch.softmax(scaling * e, dim=-1)


def _context(w, enc):
    """sum_t w[n, t] enc[n, t] in the promoted dtype (JAX's einsum)."""
    dt = torch.promote_types(w.dtype, enc.dtype)
    return torch.einsum("nt,ntd->nd", w.to(dt), enc.to(dt))


def _loc_conv(channels: int, kernel: int, dtype) -> Conv1d:
    """flax `nn.Conv(C, (2 * (k // 2) + 1,), padding="SAME",
    use_bias=False)`, applied to an alignment (B, T) as (B, T, 1)."""
    return Conv1d(1, channels, 2 * (kernel // 2) + 1, bias=False,
                  dtype=dtype)


class _ScoreMLP(nn.Module):
    """The additive score of the location family: gvec(tanh(mlp_enc(enc)
    + mlp_dec(dec) + mlp_att(f))) -> (B, T), with `extra` (B, T, A) or
    (B, 1, A) added inside the tanh in place of mlp_att's term when the
    module has no `mlp_att`."""

    def _score(self, enc, dec_state, f=None, extra=None):
        e = self.mlp_enc(enc) + self.mlp_dec(dec_state)[:, None]
        if f is not None:
            e = e + self.mlp_att(f)
        if extra is not None:
            e = extra + e
        return self.gvec(torch.tanh(e))[..., 0]


class NoAtt(nn.Module):
    """Uniform (content-free) attention (`attentions.py:45`)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def init_state(self, batch, t_max, enc_mask):
        return {"w": _uniform_valid(enc_mask, self.dtype)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        w = state["w"]
        return _context(w, enc), w, {"w": w}


class AttDot(nn.Module):
    """tanh-dot attention (`attentions.py:93`)."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, scaling=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.scaling = scaling
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, dtype=dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        k = torch.tanh(self.mlp_enc(enc))
        q = torch.tanh(self.mlp_dec(dec_state))
        e = torch.einsum("ntd,nd->nt", k, q)
        w = _masked_softmax(e, enc_mask, self.scaling)
        return _context(w, enc), w, {}


class AttAdd(_ScoreMLP):
    """Additive (Bahdanau) attention (`attentions.py:170`)."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, scaling=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.scaling = scaling
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, bias=False, dtype=dtype)
        self.gvec = Dense(att_dim, 1, bias=False, dtype=dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        w = _masked_softmax(self._score(enc, dec_state), enc_mask,
                            self.scaling)
        return _context(w, enc), w, {}


class _LocationBase(_ScoreMLP):
    """mlp_enc, mlp_dec, mlp_att, gvec and a location conv."""

    def __init__(self, enc_dim, dec_dim, att_dim, conv_channels, conv_kernel,
                 scaling, dtype):
        super().__init__()
        self.dtype = dtype
        self.scaling = scaling
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, bias=False, dtype=dtype)
        self.mlp_att = Dense(conv_channels, att_dim, bias=False, dtype=dtype)
        self.gvec = Dense(att_dim, 1, bias=False, dtype=dtype)
        self.loc_conv = _loc_conv(conv_channels, conv_kernel, dtype)


class AttLoc(_LocationBase):
    """Location-aware attention (`attentions.py:249`): a 1-D conv over the
    previous alignment feeds the score MLP."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, conv_channels=10,
                 conv_kernel=100, scaling=2.0, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, att_dim, conv_channels,
                         conv_kernel, scaling, dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {"w": _uniform_valid(enc_mask, self.dtype)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        f = self.loc_conv(state["w"][:, :, None])
        w = _masked_softmax(self._score(enc, dec_state, f), enc_mask,
                            self.scaling)
        return _context(w, enc), w, {"w": w}


class AttCov(_ScoreMLP):
    """Coverage attention (`attentions.py:382`): the running sum of all
    past alignments (the uniform one included) enters through wvec."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, scaling=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scaling = scaling
        self.wvec = Dense(1, att_dim, dtype=dtype)
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, bias=False, dtype=dtype)
        self.gvec = Dense(att_dim, 1, bias=False, dtype=dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {"cum": _uniform_valid(enc_mask, self.dtype)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        cov = self.wvec(state["cum"][:, :, None])
        w = _masked_softmax(self._score(enc, dec_state, extra=cov), enc_mask,
                            self.scaling)
        return _context(w, enc), w, {"cum": state["cum"] + w}


class AttCovLoc(_LocationBase):
    """Coverage-location attention (`attentions.py:728`): AttLoc whose conv
    input is the coverage sum."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, conv_channels=10,
                 conv_kernel=100, scaling=2.0, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, att_dim, conv_channels,
                         conv_kernel, scaling, dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {"cum": _uniform_valid(enc_mask, self.dtype)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        f = self.loc_conv(state["cum"][:, :, None])
        w = _masked_softmax(self._score(enc, dec_state, f), enc_mask,
                            self.scaling)
        return _context(w, enc), w, {"cum": state["cum"] + w}


class AttLoc2D(_ScoreMLP):
    """2-D location attention (`attentions.py:484`): an (att_win, K) conv
    over a rolling window of the last `att_win` alignments."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, conv_channels=10,
                 conv_kernel=100, att_win=5, scaling=2.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scaling = scaling
        self.att_win = att_win
        self.filts = conv_kernel // 2
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, bias=False, dtype=dtype)
        self.mlp_att = Dense(conv_channels, att_dim, bias=False, dtype=dtype)
        self.gvec = Dense(att_dim, 1, bias=False, dtype=dtype)
        self.loc_conv = nn.Conv2d(1, conv_channels,
                                  (att_win, 2 * self.filts + 1), bias=False)

    def init_state(self, batch, t_max, enc_mask):
        w0 = _uniform_valid(enc_mask, self.dtype)
        return {"win": w0[:, None, :].repeat(1, self.att_win, 1)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        dt = self.dtype
        # VALID over the window axis, SAME over time
        f = nn.functional.conv2d(state["win"].to(dt)[:, None],
                                 self.loc_conv.weight.to(dt),
                                 padding=(0, self.filts))
        f = f[:, :, 0].transpose(1, 2)  # (B, T, C)
        w = _masked_softmax(self._score(enc, dec_state, f), enc_mask,
                            self.scaling)
        win = torch.cat([state["win"][:, 1:], w[:, None].to(
            state["win"].dtype)], dim=1)
        return _context(w, enc), w, {"win": win}


class AttLocRec(_ScoreMLP):
    """Recurrent location attention (`attentions.py:605`): conv, relu and
    a max over time of the last alignment drive a bias-free LSTM cell
    (torch gate order i, f, g, o) whose hidden state enters the score."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, conv_channels=10,
                 conv_kernel=100, scaling=2.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scaling = scaling
        self.att_dim = att_dim
        self.loc_conv = _loc_conv(conv_channels, conv_kernel, dtype)
        self.lstm_ih = Dense(conv_channels, 4 * att_dim, bias=False,
                             dtype=dtype)
        self.lstm_hh = Dense(att_dim, 4 * att_dim, bias=False, dtype=dtype)
        self.mlp_enc = Dense(enc_dim, att_dim, dtype=dtype)
        self.mlp_dec = Dense(dec_dim, att_dim, bias=False, dtype=dtype)
        self.gvec = Dense(att_dim, 1, bias=False, dtype=dtype)

    def init_state(self, batch, t_max, enc_mask):
        z = torch.zeros(batch, self.att_dim, dtype=self.dtype,
                        device=enc_mask.device)
        return {"w": _uniform_valid(enc_mask, self.dtype), "ah": z, "ac": z}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        f = self.loc_conv(state["w"][:, :, None])
        pooled = torch.relu(f).amax(dim=1)  # (B, C)
        gates = self.lstm_ih(pooled) + self.lstm_hh(state["ah"])
        i, fg, g, o = gates.chunk(4, dim=-1)
        ac = torch.sigmoid(fg) * state["ac"] + torch.sigmoid(i) * torch.tanh(g)
        ah = torch.sigmoid(o) * torch.tanh(ac)
        w = _masked_softmax(self._score(enc, dec_state, extra=ah[:, None]),
                            enc_mask, self.scaling)
        return _context(w, enc), w, {"w": w, "ah": ah, "ac": ac}


class _MultiHeadBase(nn.Module):
    """mlp_k, mlp_v, mlp_q and mlp_o of the multi-head family, the
    reference's per-head Linear lists fused into (in, H * d) projections."""

    def __init__(self, enc_dim, dec_dim, heads, att_dim_k, att_dim_v,
                 out_dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.heads = heads
        self.att_dim_k = att_dim_k
        self.att_dim_v = att_dim_v
        self.mlp_k = Dense(enc_dim, heads * att_dim_k, bias=False,
                           dtype=dtype)
        self.mlp_v = Dense(enc_dim, heads * att_dim_v, bias=False,
                           dtype=dtype)
        self.mlp_q = Dense(dec_dim, heads * att_dim_k, dtype=dtype)
        self.mlp_o = Dense(heads * att_dim_v, out_dim, bias=False,
                           dtype=dtype)

    def _kvq(self, enc, dec_state):
        b, t, _ = enc.shape
        h, dk, dv = self.heads, self.att_dim_k, self.att_dim_v
        return (self.mlp_k(enc).reshape(b, t, h, dk),
                self.mlp_v(enc).reshape(b, t, h, dv),
                self.mlp_q(dec_state).reshape(b, h, dk))

    def _out(self, w, v):
        c = torch.einsum("nht,nthv->nhv", w, v).reshape(w.shape[0], -1)
        return self.mlp_o(c), w.mean(dim=1)


class AttMultiHeadDot(_MultiHeadBase):
    """Multi-head tanh-dot attention (`attentions.py:844`)."""

    def __init__(self, enc_dim, dec_dim, heads=4, att_dim_k=64, att_dim_v=64,
                 out_dim=256, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, heads, att_dim_k, att_dim_v,
                         out_dim, dtype)

    def init_state(self, batch, t_max, enc_mask):
        return {}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        k, v, q = self._kvq(enc, dec_state)
        e = torch.einsum("nthk,nhk->nht", torch.tanh(k), torch.tanh(q))
        scale = float(1.0 / torch.sqrt(torch.tensor(float(self.att_dim_k))))
        w = _masked_softmax(e, enc_mask[:, None, :], scale)
        c, wm = self._out(w, v)
        return c, wm, {}


class AttMultiHeadAdd(_MultiHeadBase):
    """Multi-head additive attention (`attentions.py:957`)."""

    def __init__(self, enc_dim, dec_dim, heads=4, att_dim_k=64, att_dim_v=64,
                 out_dim=256, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, heads, att_dim_k, att_dim_v,
                         out_dim, dtype)
        self.gvec = nn.Parameter(torch.zeros(heads, att_dim_k))

    def init_state(self, batch, t_max, enc_mask):
        return {}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        k, v, q = self._kvq(enc, dec_state)
        h = torch.tanh(k + q[:, None])
        e = torch.einsum("nthk,hk->nht", h, self.gvec.to(self.dtype))
        w = _masked_softmax(e, enc_mask[:, None, :],
                            1.0 / float(self.att_dim_k) ** 0.5)
        c, wm = self._out(w, v)
        return c, wm, {}


class AttMultiHeadLoc(_MultiHeadBase):
    """AttMultiHeadLoc (`attentions.py:1074`) and, with `multi_res`,
    AttMultiHeadMultiResLoc (`:1231`): a location conv per head, of
    width 2 * (conv_kernel // 2 * (h + 1) // heads) + 1 for head h when
    `multi_res`."""

    def __init__(self, enc_dim, dec_dim, heads=4, att_dim_k=64, att_dim_v=64,
                 out_dim=256, conv_channels=10, conv_kernel=100,
                 multi_res=False, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, heads, att_dim_k, att_dim_v,
                         out_dim, dtype)
        self.multi_res = multi_res
        base = conv_kernel // 2
        for hd in range(heads):
            filts = base * (hd + 1) // heads if multi_res else base
            self.add_module(f"loc_conv{hd}",
                            _loc_conv(conv_channels, 2 * filts + 1, dtype))
            self.add_module(f"mlp_att{hd}", Dense(conv_channels, att_dim_k,
                                                  bias=False, dtype=dtype))
        self.gvec = nn.Parameter(torch.zeros(heads, att_dim_k))

    def init_state(self, batch, t_max, enc_mask):
        w0 = _uniform_valid(enc_mask, self.dtype)
        return {"w": w0[:, None, :].repeat(1, self.heads, 1)}

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        k, v, q = self._kvq(enc, dec_state)
        fs = [getattr(self, f"mlp_att{hd}")(
            getattr(self, f"loc_conv{hd}")(state["w"][:, hd, :, None]))
            for hd in range(self.heads)]
        e = torch.tanh(k + q[:, None] + torch.stack(fs, dim=2))
        e = torch.einsum("nthk,hk->nht", e, self.gvec.to(self.dtype))
        # the reference's AttMultiHeadLoc scales by its forward's default
        # 2.0; MultiResLoc by 1/sqrt(dk)
        scaling = (1.0 / float(self.att_dim_k) ** 0.5 if self.multi_res
                   else 2.0)
        w = _masked_softmax(e, enc_mask[:, None, :], scaling)
        c, wm = self._out(w, v)
        return c, wm, {"w": w}


class AttForward(_LocationBase):
    """Forward attention (`attentions.py:1387`): location scores reweighted
    by the forward recursion (w_prev + shift(w_prev)), renormalised."""

    def __init__(self, enc_dim, dec_dim, att_dim=320, conv_channels=10,
                 conv_kernel=100, scaling=1.0, dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, att_dim, conv_channels,
                         conv_kernel, scaling, dtype)

    def init_state(self, batch, t_max, enc_mask):
        w0 = torch.zeros(batch, t_max, dtype=self.dtype,
                         device=enc_mask.device)
        w0[:, 0] = 1.0
        return {"w": w0}

    def _forward_weights(self, enc, enc_mask, dec_state, w_prev):
        f = self.loc_conv(w_prev[:, :, None])
        w = _masked_softmax(self._score(enc, dec_state, f), enc_mask,
                            self.scaling)
        shift = nn.functional.pad(w_prev, (1, 0))[:, :-1]
        return w, shift

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        w_prev = state["w"]
        w, shift = self._forward_weights(enc, enc_mask, dec_state, w_prev)
        w = ((w_prev + shift) * w).clamp(min=1e-6)
        w = w / w.sum(dim=-1, keepdim=True)
        return _context(w, enc), w, {"w": w}


class AttForwardTA(AttForward):
    """Forward attention with a transition agent (`attentions.py:1517`):
    the stay/move blend comes from [context, previous output, decoder
    state]."""

    def __init__(self, enc_dim, dec_dim, out_prev_dim, att_dim=320,
                 conv_channels=10, conv_kernel=100, scaling=1.0,
                 dtype=torch.float32):
        super().__init__(enc_dim, dec_dim, att_dim, conv_channels,
                         conv_kernel, scaling, dtype)
        self.mlp_ta = Dense(enc_dim + out_prev_dim + dec_dim, 1, dtype=dtype)

    def init_state(self, batch, t_max, enc_mask):
        st = super().init_state(batch, t_max, enc_mask)
        st["ta"] = torch.full((batch, 1), 0.5, dtype=self.dtype,
                              device=enc_mask.device)
        return st

    def forward(self, enc, enc_mask, dec_state, state, out_prev=None):
        if out_prev is None:
            raise ValueError("AttForwardTA needs the previous output")
        w_prev, ta = state["w"], state["ta"]
        w, shift = self._forward_weights(enc, enc_mask, dec_state, w_prev)
        w = ((ta * w_prev + (1.0 - ta) * shift) * w).clamp(min=1e-6)
        w = w / w.sum(dim=-1, keepdim=True)
        context = _context(w, enc)
        ta_new = torch.sigmoid(self.mlp_ta(
            torch.cat([context, out_prev.to(context.dtype),
                       dec_state.to(context.dtype)], dim=-1)))
        return context, w, {"w": w, "ta": ta_new}


def make_attention(att_type: str, enc_dim: int, dec_dim: int, *,
                   att_dim=320, conv_channels=10, conv_kernel=100, heads=4,
                   att_win=5, out_dim=256,
                   out_prev_dim: Optional[int] = None,
                   dtype=torch.float32) -> nn.Module:
    """The factory of `initial_att` (`attentions.py:1650`), the JAX
    `make_attention`'s arguments plus the input widths. `conv_kernel` is
    the full kernel length; `out_dim` the multi-head variants' mlp_o
    width (eprojs); `out_prev_dim` AttForwardTA's previous-output width."""
    loc = dict(att_dim=att_dim, conv_channels=conv_channels,
               conv_kernel=conv_kernel, dtype=dtype)
    mh = dict(heads=heads, att_dim_k=att_dim, att_dim_v=att_dim,
              out_dim=out_dim, dtype=dtype)
    if att_type == "noatt":
        return NoAtt(dtype=dtype)
    if att_type == "dot":
        return AttDot(enc_dim, dec_dim, att_dim=att_dim, dtype=dtype)
    if att_type == "add":
        return AttAdd(enc_dim, dec_dim, att_dim=att_dim, dtype=dtype)
    if att_type == "location":
        return AttLoc(enc_dim, dec_dim, **loc)
    if att_type == "coverage":
        return AttCov(enc_dim, dec_dim, att_dim=att_dim, dtype=dtype)
    if att_type == "coverage_location":
        return AttCovLoc(enc_dim, dec_dim, **loc)
    if att_type == "location2d":
        return AttLoc2D(enc_dim, dec_dim, att_win=att_win, **loc)
    if att_type == "location_recurrent":
        return AttLocRec(enc_dim, dec_dim, **loc)
    if att_type == "multi_head_dot":
        return AttMultiHeadDot(enc_dim, dec_dim, **mh)
    if att_type == "multi_head_add":
        return AttMultiHeadAdd(enc_dim, dec_dim, **mh)
    if att_type in ("multi_head_loc", "multi_head_multi_res_loc"):
        return AttMultiHeadLoc(
            enc_dim, dec_dim, conv_channels=conv_channels,
            conv_kernel=conv_kernel,
            multi_res=att_type == "multi_head_multi_res_loc", **mh)
    if att_type == "forward":
        return AttForward(enc_dim, dec_dim, **loc)
    if att_type == "forward_ta":
        if out_prev_dim is None:
            raise ValueError("forward_ta needs out_prev_dim")
        return AttForwardTA(enc_dim, dec_dim, out_prev_dim, **loc)
    raise ValueError(f"unknown att_type: {att_type!r} (choices: {ATT_TYPES})")

