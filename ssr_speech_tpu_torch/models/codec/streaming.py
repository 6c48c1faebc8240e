"""Chunked streaming inference for the causal SEANet codec (port of
``ssr_speech_tpu/models/codec/streaming.py``).

Audio is processed in fixed-size chunks while each layer's state is carried,
so that the concatenated streamed output equals the offline causal pass.
State is an explicit tree (dicts and lists of tensors) that mirrors the
parameter tree, and every ``*_step`` function is ``(params, state, chunk) ->
(out, state)``. Layouts are the codec's: activations [B, T, C], conv weights
[K, Cin, Cout], transposed around ``torch.nn.functional`` as in ``conv.py``.

Per-layer state:
- causal conv (kernel K, stride S, dilation D): the last ``(K-1)*D + 1 - S``
  input samples (the left context the offline pass reads through its causal
  padding; zeros at the stream's start);
- causal transposed conv (``trim_right_ratio=1.0``): the overlap-add tail of
  ``K - S`` output samples carried into the next chunk (the bias is added
  only on emission, so the overlap is not biased twice);
- LSTM: the (h, c) carry of each layer, through ``torch.lstm`` (cuDNN on the
  card).

Each chunk must be a multiple of the codec hop (encoder) or one latent frame
(decoder), so that every strided conv consumes its input exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ...config import CodecConfig, SEANetConfig
from ...utils.tree import tree_map
from . import conv as cv
from . import quantize as q
from . import seanet

State = Dict[str, Any]

act = seanet.act


# ------------------------------------------------------------ conv primitives

def _conv_state(batch: int, kernel: int, stride: int, dilation: int, cin: int,
                dtype=torch.float32, device="cpu") -> torch.Tensor:
    pad = (kernel - 1) * dilation + 1 - stride
    return torch.zeros((batch, max(pad, 0), cin), dtype=dtype, device=device)


def conv1d_step(p, x: torch.Tensor, state: torch.Tensor, stride: int = 1,
                dilation: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal streaming conv. ``state`` holds the left context; the chunk
    length must be a stride multiple."""
    assert x.shape[1] % stride == 0, (x.shape, stride)
    xx = torch.cat([state.to(x.dtype), x], dim=1)
    w = cv.conv_weight(p).to(x.dtype)
    y = F.conv1d(xx.transpose(1, 2), w.permute(2, 1, 0), p["b"].to(x.dtype),
                 stride=stride, dilation=dilation).transpose(1, 2)
    keep = state.shape[1]
    new_state = xx[:, xx.shape[1] - keep:] if keep else state
    return y, new_state


def _convtr_state(batch: int, kernel: int, stride: int, cout: int,
                  dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros((batch, kernel - stride, cout), dtype=dtype,
                       device=device)


def conv_transpose1d_step(p, x: torch.Tensor, state: torch.Tensor,
                          stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal streaming transposed conv (``trim_right_ratio=1.0``): emits
    ``C*stride`` samples per ``C``-frame chunk and carries the ``K - S``
    overlap; the bias is added to the emitted samples only."""
    w = cv.conv_weight(p).to(x.dtype)
    k = w.shape[0]
    # [B, (C-1)*stride + k, Cout], no bias yet (conv.conv_transpose1d's kernel)
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0),
                           None, stride=stride).transpose(1, 2)
    emit_len = x.shape[1] * stride
    tail = k - stride
    y = torch.cat([y[:, :tail] + state.to(x.dtype), y[:, tail:]], dim=1)
    out = y[:, :emit_len] + p["b"].to(x.dtype)
    return out, y[:, emit_len:]


def _lstm_state(batch: int, dim: int, n_layers: int, dtype=torch.float32,
                device="cpu"):
    return [(torch.zeros((batch, dim), dtype=dtype, device=device),
             torch.zeros((batch, dim), dtype=dtype, device=device))
            for _ in range(n_layers)]


def lstm_skip_step(p, x: torch.Tensor, state) -> Tuple[torch.Tensor, Any]:
    """StreamableLSTM step with the (h, c) of each layer carried; the JAX
    weights are torch's own layout and gate order, so they feed
    ``torch.lstm`` as they are (as ``conv.lstm_skip``)."""
    layers = list(p["layers"])
    weights = []
    for lp in layers:
        weights += [lp["wih"], lp["whh"], lp["bih"], lp["bhh"]]
    h0 = torch.stack([h for h, _ in state]).to(x.dtype)
    c0 = torch.stack([c for _, c in state]).to(x.dtype)
    y, h1, c1 = torch.lstm(x, (h0, c0), weights, True, len(layers), 0.0,
                           False, False, True)
    return y + x, [(h1[i], c1[i]) for i in range(len(layers))]


def _resblock_state(batch: int, cfg: SEANetConfig, dim: int, dilation: int,
                    dtype=torch.float32, device="cpu") -> State:
    hidden = dim // cfg.compress
    return dict(
        conv1=_conv_state(batch, cfg.residual_kernel_size, 1, dilation, dim,
                          dtype, device),
        conv2=_conv_state(batch, 1, 1, 1, hidden, dtype, device))


def resblock_step(p, x: torch.Tensor, state: State,
                  dilation: int) -> Tuple[torch.Tensor, State]:
    h, s1 = conv1d_step(p["conv1"], act(x), state["conv1"], dilation=dilation)
    h, s2 = conv1d_step(p["conv2"], act(h), state["conv2"])
    return x + h, dict(conv1=s1, conv2=s2)


# -------------------------------------------------------------------- encoder

def init_encoder_state(cfg: SEANetConfig, batch: int = 1,
                       dtype=torch.float32, device="cpu") -> State:
    assert cfg.causal, "streaming requires the causal codec mode"
    mult = 1
    groups = []
    for ratio in reversed(cfg.ratios):
        dim = mult * cfg.n_filters
        res = [_resblock_state(batch, cfg, dim, cfg.dilation_base ** j, dtype,
                               device) for j in range(cfg.n_residual_layers)]
        down = _conv_state(batch, ratio * 2, ratio, 1, dim, dtype, device)
        groups.append(dict(res=res, down=down))
        mult *= 2
    state: State = dict(
        conv_in=_conv_state(batch, cfg.kernel_size, 1, 1, cfg.channels, dtype,
                            device),
        groups=groups,
        conv_out=_conv_state(batch, cfg.last_kernel_size, 1, 1,
                             mult * cfg.n_filters, dtype, device))
    if cfg.lstm:
        state["lstm"] = _lstm_state(batch, mult * cfg.n_filters, cfg.lstm,
                                    dtype, device)
    return state


def encode_step(p, state: State, chunk: torch.Tensor, cfg: SEANetConfig,
                return_taps: bool = False):
    """chunk [B, C, channels] (C a hop multiple) -> latents [B, C/hop, dim].
    With ``return_taps`` also the per-resolution intermediates the watermark
    decoder fuses (the boundaries of ``seanet.encode``)."""
    new: State = dict(groups=[])
    taps = []
    h, new["conv_in"] = conv1d_step(p["conv_in"], chunk, state["conv_in"])
    enc_ratios = list(reversed(cfg.ratios))
    for i, g in enumerate(p["groups"]):
        gs = state["groups"][i]
        ns = dict(res=[])
        for j, rp in enumerate(g["res"]):
            h, rs = resblock_step(rp, h, gs["res"][j], cfg.dilation_base ** j)
            ns["res"].append(rs)
        if return_taps:
            taps.append(h)
        h, ns["down"] = conv1d_step(g["down"], act(h), gs["down"],
                                    stride=enc_ratios[i])
        new["groups"].append(ns)
    if "lstm" in p:
        h, new["lstm"] = lstm_skip_step(p["lstm"], h, state["lstm"])
    h, new["conv_out"] = conv1d_step(p["conv_out"], act(h), state["conv_out"])
    if return_taps:
        taps.append(h)
        return h, taps, new
    return h, new


# -------------------------------------------------------------------- decoder

def init_decoder_state(cfg: SEANetConfig, batch: int = 1,
                       dtype=torch.float32, device="cpu") -> State:
    assert cfg.causal, "streaming requires the causal codec mode"
    assert cfg.trim_right_ratio >= 1.0, \
        "streaming decode requires trim_right_ratio=1.0 (fully causal upconvs)"
    mult = int(2 ** len(cfg.ratios))
    state: State = dict(
        conv_in=_conv_state(batch, cfg.kernel_size, 1, 1, cfg.dimension, dtype,
                            device),
        groups=[])
    if cfg.lstm:
        state["lstm"] = _lstm_state(batch, mult * cfg.n_filters, cfg.lstm,
                                    dtype, device)
    for ratio in cfg.ratios:
        dim_out = mult * cfg.n_filters // 2
        up = _convtr_state(batch, ratio * 2, ratio, dim_out, dtype, device)
        res = [_resblock_state(batch, cfg, dim_out, cfg.dilation_base ** j,
                               dtype, device)
               for j in range(cfg.n_residual_layers)]
        state["groups"].append(dict(up=up, res=res))
        mult //= 2
    state["conv_out"] = _conv_state(batch, cfg.last_kernel_size, 1, 1,
                                    cfg.n_filters, dtype, device)
    return state


def decode_step(p, state: State, z: torch.Tensor,
                cfg: SEANetConfig) -> Tuple[torch.Tensor, State]:
    """z [B, F, dimension] -> waveform chunk [B, F*hop, channels]."""
    new: State = dict(groups=[dict(res=[]) for _ in cfg.ratios])
    h, new["conv_in"] = conv1d_step(p["conv_in"], z, state["conv_in"])
    if "lstm" in p:
        h, new["lstm"] = lstm_skip_step(p["lstm"], h, state["lstm"])
    for i, ratio in enumerate(cfg.ratios):
        g = p["groups"][i]
        if i > 0:
            prev = p["groups"][i - 1]
            for j, rp in enumerate(prev["res"]):
                h, rs = resblock_step(rp, h, state["groups"][i - 1]["res"][j],
                                      cfg.dilation_base ** j)
                new["groups"][i - 1]["res"].append(rs)
        h, new["groups"][i]["up"] = conv_transpose1d_step(
            g["up"], act(h), state["groups"][i]["up"], stride=ratio)
    for j, rp in enumerate(p["groups"][-1]["res"]):
        h, rs = resblock_step(rp, h, state["groups"][-1]["res"][j],
                              cfg.dilation_base ** j)
        new["groups"][-1]["res"].append(rs)
    h, new["conv_out"] = conv1d_step(p["conv_out"], act(h), state["conv_out"])
    if cfg.final_activation == "Tanh":
        h = torch.tanh(h)
    return h, new


# --------------------------------------------------------- watermark decoder

def init_wm_decoder_state(cfg: SEANetConfig, batch: int = 1,
                          dtype=torch.float32, device="cpu") -> State:
    """State for the streaming ``wm_decode``: the skip encoder, the decoder
    and the detector's encoder streams run in lockstep."""
    return dict(skip=init_encoder_state(cfg, batch, dtype, device),
                dec=init_decoder_state(cfg, batch, dtype, device),
                wm_enc=init_encoder_state(cfg, batch, dtype, device))


def wm_decode_step(p, state: State, latents: torch.Tensor,
                   labels: torch.Tensor, wav_chunk: torch.Tensor,
                   cfg: SEANetConfig):
    """Streaming watermark decoder step (offline: ``seanet.wm_decode``).
    ``latents`` [B, F, dim], ``labels`` [B, F] in {0, 1}, ``wav_chunk``
    [B, F*hop, C] the original (masked) waveform. The skip-encoder taps, the
    label fusions (1x1 projections, stateless) and the decoder stages all
    run at chunk-aligned rates, so the plain streams' states suffice.
    Returns (audio [B, F*hop, C], detector logits [B, F, 2], state)."""
    n_up = len(cfg.ratios)
    _, taps, skip_s = encode_step(p["skip_encoder"], state["skip"], wav_chunk,
                                  cfg, return_taps=True)
    used = taps[1:]  # the full-rate tap is not fused (as offline)
    dp = p["decoder"]
    ds = state["dec"]
    new_dec: State = dict(groups=[dict(res=[]) for _ in cfg.ratios])
    x = latents
    for stage in range(n_up):
        tap = used[n_up - 1 - stage]
        rep = 1
        for r in cfg.ratios[:stage]:
            rep *= r
        lab = torch.repeat_interleave(labels, rep, dim=1) if rep > 1 else labels
        emb = seanet._wm_embed(p, lab)
        fused = torch.cat([tap, emb.to(tap.dtype)], dim=-1)
        x = seanet._proj(p["projs"][stage], fused, cfg) + x
        if stage == 0:
            x, new_dec["conv_in"] = conv1d_step(dp["conv_in"], x,
                                                ds["conv_in"])
            if "lstm" in dp:
                x, new_dec["lstm"] = lstm_skip_step(dp["lstm"], x, ds["lstm"])
        else:
            prev = dp["groups"][stage - 1]
            for j, rp in enumerate(prev["res"]):
                x, rs = resblock_step(rp, x, ds["groups"][stage - 1]["res"][j],
                                      cfg.dilation_base ** j)
                new_dec["groups"][stage - 1]["res"].append(rs)
        x, new_dec["groups"][stage]["up"] = conv_transpose1d_step(
            dp["groups"][stage]["up"], act(x), ds["groups"][stage]["up"],
            stride=cfg.ratios[stage])
    for j, rp in enumerate(dp["groups"][-1]["res"]):
        x, rs = resblock_step(rp, x, ds["groups"][-1]["res"][j],
                              cfg.dilation_base ** j)
        new_dec["groups"][-1]["res"].append(rs)
    x, new_dec["conv_out"] = conv1d_step(dp["conv_out"], act(x),
                                         ds["conv_out"])
    if cfg.final_activation == "Tanh":
        x = torch.tanh(x)
    audio = x
    m, wm_s = encode_step(p["wm_encoder"], state["wm_enc"], audio, cfg)
    logits = seanet._proj(p["predictor"], m, cfg)  # 1x1 conv: stateless
    return audio, logits, dict(skip=skip_s, dec=new_dec, wm_enc=wm_s)


# ------------------------------------------------------------- codec facade

def _device(params) -> torch.device:
    return params["quantizer"]["embed"].device


class StreamingCodec:
    """Stateful convenience wrapper: feed waveform chunks, get codes; feed
    codes, get waveform (the chunked ``wmencodec.encode`` / ``decode``, one
    stream per instance) on the device of ``params``."""

    def __init__(self, params, cfg: CodecConfig, batch: int = 1,
                 dtype=torch.float32):
        self.params = params
        self.cfg = cfg
        dev = _device(params)
        self.enc_state = init_encoder_state(cfg.seanet, batch, dtype, dev)
        self.dec_state = init_decoder_state(cfg.seanet, batch, dtype, dev)

    @torch.no_grad()
    def encode_chunk(self, wav_chunk: torch.Tensor) -> torch.Tensor:
        """wav [B, C, channels], C a hop multiple -> codes [B, K, C/hop]."""
        assert wav_chunk.shape[1] % self.cfg.hop_length == 0, \
            (wav_chunk.shape, self.cfg.hop_length)
        emb, self.enc_state = encode_step(self.params["encoder"],
                                          self.enc_state, wav_chunk,
                                          self.cfg.seanet)
        return q.rvq_encode(self.params["quantizer"], emb)

    @torch.no_grad()
    def decode_chunk(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, F] -> waveform [B, F*hop, channels]."""
        latents = q.rvq_decode(self.params["quantizer"], codes)
        out, self.dec_state = decode_step(self.params["decoder"],
                                          self.dec_state, latents,
                                          self.cfg.seanet)
        return out


# ---------------------------------------------------------- batched lanes

def _rows_where(mask: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    m = mask.reshape((mask.shape[0],) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


class LaneDecoder:
    """``n_lanes`` independent causal decoder streams advanced by one batched
    call per chunk: the multi-client counterpart of
    :class:`StreamingCodec`.

    ``step`` advances only the lanes marked ``active``: the inactive rows keep
    their conv and LSTM state bit for bit (``torch.where`` on every state
    leaf, as JAX's ``_lane_decode_jit``), so callers batch whichever lanes
    have a full chunk pending. ``reset`` zeroes a lane's state for the next
    stream (zeros are a fresh stream's state)."""

    def __init__(self, params, cfg: CodecConfig, n_lanes: int,
                 dtype=torch.float32):
        if not cfg.seanet.causal:
            raise ValueError("LaneDecoder needs a causal codec config")
        self.params, self.cfg = params, cfg
        self.n_lanes = n_lanes
        self.dtype = dtype
        self.device = _device(params)
        self.state = init_decoder_state(cfg.seanet, n_lanes, dtype,
                                        self.device)

    def _mask(self, lanes) -> torch.Tensor:
        return torch.as_tensor(lanes, dtype=torch.bool).to(self.device)

    def reset(self, lane_mask) -> None:
        """Zero the state rows where ``lane_mask`` [n_lanes] is True."""
        m = self._mask(lane_mask)
        self.state = tree_map(lambda leaf: _rows_where(
            m, torch.zeros_like(leaf), leaf), self.state)

    @torch.no_grad()
    def warm_lane(self, lane: int, codes, chunk: int = 50) -> int:
        """Advance lane ``lane`` from a fresh state over the leading
        ``(T // chunk) * chunk`` frames of ``codes`` [K, T] at batch 1, then
        write the warmed state into the lane's row. Returns the frames
        consumed; the rest (< ``chunk``) is the caller's to feed through
        :meth:`step`, where it shares a step with the first generated
        frames."""
        T = codes.shape[1]
        n = (T // chunk) * chunk
        if n == 0:
            return 0
        s = init_decoder_state(self.cfg.seanet, 1, self.dtype, self.device)
        codes = torch.as_tensor(codes).to(self.device, torch.int64)
        for i in range(0, n, chunk):
            latents = q.rvq_decode(self.params["quantizer"],
                                   codes[None, :, i:i + chunk])
            _, s = decode_step(self.params["decoder"], s, latents,
                               self.cfg.seanet)

        def put(leaf, warm):
            leaf[lane] = warm[0].to(leaf.dtype)
            return leaf

        self.state = tree_map(put, self.state, s)
        return n

    @torch.no_grad()
    def step(self, codes, active) -> torch.Tensor:
        """codes [n_lanes, K, f] -> waveform [n_lanes, f*hop, channels].
        Rows with ``active`` False keep their state; their output rows are
        not meaningful (callers discard them). The result stays on the
        device, so consecutive steps queue without a host sync."""
        codes = torch.as_tensor(codes).to(self.device, torch.int64)
        latents = q.rvq_decode(self.params["quantizer"], codes)
        out, new = decode_step(self.params["decoder"], self.state, latents,
                               self.cfg.seanet)
        m = self._mask(active)
        self.state = tree_map(lambda n, o: _rows_where(m, n, o), new,
                              self.state)
        return out
