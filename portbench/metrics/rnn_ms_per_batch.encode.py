"""Device milliseconds of the LSTM a batch of the encode cell: cuDNN's RNN
kernels and the matrix-vector products its recurrence runs at batch 16
(cuBLAS's gemv kernels; the encoder has no other), from the profile of the
batches traced after the window."""


def read(out, ctx):
    prof = out.profile
    n = len(out.traced)
    ms = prof and sum(prof["groups"].get(g, 0.0) for g in ("rnn", "gemv"))
    if not prof or not n or ms <= 0.0:
        return None
    return 1e3 * ms / n
