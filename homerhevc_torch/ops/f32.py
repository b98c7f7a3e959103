"""float32 arithmetic in the reference's evaluation order.

The encoder's RD decisions are argmins over float32 costs built from
fractional bit estimates; two evaluation orders of one formula can round
one ulp apart and flip a near tie.  The JAX reference compiles those
formulas with XLA on the CPU, which

* contracts `c + a * b` into one fused multiply-add (a single rounding),
* reduces a row in consecutive 32-element chunks, each summed left to
  right, then sums the chunk partials left to right; a row of at most 32
  is summed left to right, or, where XLA vectorizes the loop, in a
  halving tree (x[:n/2] + x[n/2:], repeated),
* evaluates a cumulative sum in 16-element chunks (a left-to-right prefix
  inside each chunk, then the prefix of the chunk totals added on),
* sums a whole 2-D grid by first reducing each dimension longer than 32
  in windows of 32 (zero padding split evenly around the grid), each
  window element by element in row-major order, then summing what is
  left: row by row, then over the rows in a halving tree where there
  are 2, 4 or 8 rows of at most 8, else element by element; a block of
  16-32 rows by 4 or 8 columns (the grid, or an unpadded window of 32
  rows) is summed in vector lanes instead (`_lane_sum`),
* sums a grid cut into row bands over n devices (jnp.sum per band, then
  psum) as the band sums added left to right in device order: the
  CPU's all-reduce folds the devices' values in order (read off a
  shard_map program on 2, 3, 4 and 8 virtual CPU devices),
* divides by a constant as a multiply by its float32 reciprocal,
* evaluates `2.0 ** y` as the correctly rounded power of two.

The helpers here reproduce those orders with plain tensor ops, so the
port's costs are bit-identical on every device.  The fused multiply-add
is evaluated in float64 (the product of two float32 values is exact
there) and rounded once to float32.
"""
from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding (tensors or Python floats;
    at least one argument must be a tensor)."""

    def d(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        # the float32 value as a Python float: an operand of the kernel,
        # not a tensor to upload
        return float(torch.tensor(x, dtype=torch.float32))
    return (d(a) * d(b) + d(c)).to(torch.float32)


def row_sum(x: torch.Tensor, tree: bool = False) -> torch.Tensor:
    """float32 sum over the last axis in XLA-CPU order (`tree`: a row of
    at most 32 that XLA sums in a halving tree)."""
    n = x.shape[-1]
    if n <= 32 and tree:
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            x = x[..., :h] + x[..., h:]
        return x[..., 0]
    if n <= 32:
        return _seq(x.unbind(-1))
    assert n % 32 == 0, n
    chunks = x.reshape(*x.shape[:-1], n // 32, 32)
    part = _seq(chunks.unbind(-1))                   # [..., n/32]
    return _seq(part.unbind(-1))


def _seq(cols) -> torch.Tensor:
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


def _lanes(r: int, c: int):
    """Vector lanes of XLA-CPU's loop over an r x c block, or None where
    it sums element by element.

    LLVM's loop vectorizer runs the row loop of a 4- or 8-column block of
    16-32 rows in lanes of 256 bits (XLA's prefer-vector-width, whatever
    wider vectors the host has): 8 float32 lanes when the rows come in
    whole groups of 8 and a row is 4 wide, else 4 lanes (read off
    `*.ir-with-opt.ll` under XLA_FLAGS=--xla_dump_to on an AVX-512 host;
    a host without 256-bit vectors would take other lanes)."""
    if c not in (4, 8) or not 16 <= r <= 32:
        return None
    return 8 if c == 4 and r % 8 == 0 else 4


def _lane_sum(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Sum of each [..., r, c] block as the vectorized loop does it: lane
    l adds rows l, l + lanes, ... element by element, then the lanes are
    reduced in a halving tree."""
    r, c = x.shape[-2:]
    rows = x.reshape(*x.shape[:-2], r // lanes, lanes, c).transpose(-3, -2)
    acc = _seq(rows.reshape(*x.shape[:-2], lanes, -1).unbind(-1))
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def grid_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of a 2-D grid [r, c] in XLA-CPU's order (jnp.sum of
    the whole grid; the order was read off XLA's optimised program and
    checked against it for every multiple-of-4 shape up to 68 x 120)."""
    r, c = x.shape
    if _lanes(r, c):
        return _lane_sum(x, _lanes(r, c))
    if r > 32 or c > 32:
        def window(n):            # (window, padding before, after)
            if n <= 32:
                return n, 0, 0
            pad = -n % 32
            return 32, pad // 2, pad - pad // 2
        (wr, lr, hr), (wc, lc, hc) = window(r), window(c)
        xp = torch.nn.functional.pad(x, (lc, hc, lr, hr))
        nr, nc = xp.shape[0] // wr, xp.shape[1] // wc
        win = xp.reshape(nr, wr, nc, wc).permute(0, 2, 1, 3)
        if lr + hr == 0 and _lanes(wr, wc):
            x = _lane_sum(win, _lanes(wr, wc))
        else:
            x = _seq(win.reshape(nr, nc, wr * wc).unbind(-1))
        r, c = nr, nc
    if r in (2, 4, 8) and c <= 8:
        x = _seq(x.unbind(-1))
        while x.shape[0] > 1:
            x = x[:x.shape[0] // 2] + x[x.shape[0] // 2:]
        return x[0]
    return _seq(x.reshape(-1).unbind(0))


def band_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 sum of a grid [r, c] cut into n bands of r/n rows, as the
    reference's row-sharded program sums it: grid_sum of each band, then
    the band sums added left to right (n = 1: grid_sum)."""
    return _seq([grid_sum(b) for b in x.chunk(n)])


def cumsum0(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive cumulative sum over axis 0 in XLA-CPU order."""
    n = x.shape[0]
    if n <= 16:
        out, acc = [], None
        for i in range(n):
            acc = x[i] if acc is None else acc + x[i]
            out.append(acc)
        return torch.stack(out)
    m = -(-n // 16) * 16
    if m > n:
        x = torch.cat([x, x.new_zeros((m - n,) + x.shape[1:])])
    ch = x.reshape(m // 16, 16, *x.shape[1:])
    pre = torch.stack([cumsum0(c) for c in ch])      # [nc, 16, ...]
    tot = cumsum0(pre[:, -1])
    carry = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
    return (pre + carry[:, None]).reshape(m, *x.shape[1:])[:n]


def exp2(y: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 2**y of a float32 tensor."""
    return torch.exp2(y.to(torch.float64)).to(torch.float32)
