"""The decode-attention kernels' wrappers beside their plain versions:

* ``gqa_decode`` — one query token per sequence against a (B, C, Hkv, D)
  KV cache, GQA groups, optional tanh softcap;
* ``mla_decode`` — the matrix-absorbed MLA form against the latent cache
  (ckv, krope), returning the latent context.

Each takes one of two routes, by dtype and shape alone:

* ``gqa_route(dtype, q_per_kv, D)``: bf16 with at most 16 query heads per
  kv head and D a multiple of 16 up to 256 runs the split-KV kernel
  ``k_gqa_split`` (``csrc/decode_attention.cu``: cp.async ring of bf16
  tiles, tensor-core products, tiles with no valid row skipped; the split
  count from ``split_plan``);
* ``mla_route(dtype, H, R, Dr)``: bf16 with R and Dr multiples of 16 (R
  up to 512, Dr up to 64) and any H runs ``k_mla`` (``csrc/mla_decode.cu``:
  all heads of a sequence in one block where they fit, so the latent
  cache is read once; the same ring, mask-first tile list and
  tensor-core products; the plan from ``mla_split_plan``);
* every other shape, and f32, the per-chunk kernel ``k_partial``, which
  takes any width (one element a load where a width is not a multiple of
  4).

Each wrapper takes the device of its tensors as the route: a CUDA tensor
launches the kernel (or raises; a kernel that fails is never replaced by
another), a CPU tensor runs the plain version in ``ref``. Each counts its
own launches in ``.launches`` and by route in ``.route_launches``. The
Pallas wrapper pads C to a divisor of its block; the CUDA kernels take
any C and mask the ragged edge themselves.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.device import bool_bytes, on_device, sm_count

# f32 GQA and MLA: cache rows per block (one chunk). GQA's 64-row tiles
# take 71 KB of shared memory at D = 128 (3 blocks an SM); MLA's 32-row
# tiles with all 40 heads' queries 88 KB (2 an SM)
_GQA_ROWS = 64
_MLA_ROWS = 32
# bf16 GQA: rows per tile (kRows in the source), the most query heads per
# kv head (kHeads, mma's M), and the blocks aimed at per SM (its 3-stage
# ring takes 109 KB of shared memory at D = 128: two blocks an SM)
SPLIT_TILE = 64
SPLIT_MAX_G = 16
SPLIT_BLOCKS_PER_SM = 2
# bf16 MLA (k_mla): rows per tile (kRows), the widest R and Dr it takes
MLA_TILE = 64
MLA_MAX_R, MLA_MAX_DR = 512, 64
_SOURCE = "decode_attention.cu"
_MLA_SOURCE = "mla_decode.cu"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_GQA_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 5)
_SPLIT_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
               + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
               + [ctypes.c_void_p] * 5)
_MLA_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_void_p] * 5)
_MLA_SPLIT_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 5)


_FNS = {}


def _kernel_fn(stem: str, dtype: torch.dtype, argtypes, source=_SOURCE):
    key = (stem, dtype)
    fn = _FNS.get(key)
    if fn is None:
        from repro_torch.kernels import build
        fn = getattr(build.load(source), f"{stem}_{_SUFFIX[dtype]}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def _operands(*xs: torch.Tensor):
    """Check that the operands share one CUDA device and a kernel dtype
    (f32 or bf16) → the contiguous tensors. The per-chunk kernel loads
    four elements at a time only where every base, stride and width
    allows it, else one at a time."""
    dev, dt = xs[0].device, xs[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"decode attention takes float32 or bfloat16, "
                        f"got {dt}")
    out = []
    for x in xs:
        if x.device != dev or x.dtype != dt:
            raise ValueError(f"operands must share one device and dtype: "
                             f"{x.device}/{x.dtype} vs {dev}/{dt}")
        out.append(x.contiguous())
    return out


def gqa_route(dtype: torch.dtype, q_per_kv: int, d: int) -> str:
    """The kernel ``gqa_decode`` launches on the card for a (dtype, query
    heads per kv head, head width): ``k_gqa_split`` where its tensor-core
    tiles apply (bf16, q_per_kv ≤ ``SPLIT_MAX_G``, D a multiple of 16 up
    to 256), else ``k_partial``, which takes any G and D."""
    if (dtype == torch.bfloat16 and q_per_kv <= SPLIT_MAX_G
            and d % 16 == 0 and 16 <= d <= 256):
        return "k_gqa_split"
    return "k_partial"


_SMEM_FLOATS = 227 * 1024 // 4          # a block's shared memory


def partial_plan(g: int, dk: int, dv: int, own_v: bool, rows: int
                 ) -> tuple:
    """(query heads per block, rows per chunk) of the per-chunk kernel:
    all ``g`` heads of a kv group and ``rows`` rows where their shared
    memory fits a block (the source's ``layout``: the transposed queries,
    the key rows at an odd stride, GQA's value rows and the weights, in
    floats); else the rows halve down to 16, and then the heads halve
    (one head may go down to one row). Raises when not even one head
    and one row fit."""
    gb = g
    while gb >= 1:
        gp = -(-gb // 4) * 4
        r, least = rows, (1 if gb == 1 else min(rows, 16))
        while r >= least:
            kv = r * (dk | 1) + (r * dv if own_v else 0)
            if -(-(dk * gp + kv) // 4) * 4 + r * gp <= _SMEM_FLOATS:
                return gb, r
            r //= 2
        gb = -(-gb // 2) if gb > 1 else 0
    raise ValueError(f"a query head of width {dk} does not fit one "
                     f"block's shared memory")


def _partials(b: int, h: int, c: int, dv: int, rows: int, dev):
    nch = -(-c // rows)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((b, h, nch), **f32), torch.empty((b, h, nch), **f32),
            torch.empty((b, h, nch, dv), **f32))


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def split_plan(b: int, hkv: int, c: int, sms: int) -> tuple:
    """(splits, tiles per split) of the bf16 GQA kernel: about
    ``SPLIT_BLOCKS_PER_SM`` blocks of (split, kv head, sequence) per SM,
    split ``s`` walking tiles [s * per, min((s + 1) * per, tiles)) of
    ``SPLIT_TILE`` rows, none of them empty."""
    tiles = -(-c // SPLIT_TILE)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // (b * hkv))
    per = -(-tiles // max(1, min(tiles, want)))
    return -(-tiles // per), per


def _mask_u8(valid: torch.Tensor, b: int, c: int, dev):
    """The (B or 1, C) bool mask as uint8, without a copy when it is a
    contiguous bool tensor on ``dev`` → (tensor, batch stride: C, or 0
    for a (1, C) mask)."""
    if valid.dim() != 2 or valid.shape[-1] != c or valid.shape[0] not in (1,
                                                                          b):
        raise ValueError(f"valid must be (B or 1, C) = ({b} or 1, {c}), "
                         f"got {tuple(valid.shape)}")
    return bool_bytes(valid, dev), (c if valid.shape[0] == b else 0)


def _mask(valid: torch.Tensor, b: int, c: int, dev) -> torch.Tensor:
    """The mask as a (B, C) uint8 tensor (k_partial's layout): a view when
    ``_mask_u8`` gives one of B rows, else one copy."""
    mask, bs = _mask_u8(valid, b, c, dev)
    return mask if bs or b == 1 else mask.expand(b, c).contiguous()


def _check_gqa_shapes(q, k, v, q_per_kv):
    b, one, h, d = q.shape
    _, c, hkv, dk = k.shape
    if (one != 1 or tuple(v.shape) != (b, c, hkv, d) or dk != d
            or k.shape[0] != b or h != hkv * q_per_kv or c < 1):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, q_per_kv {q_per_kv}")
    return b, h, c, hkv, d


def _launch_gqa_split(q, k, v, valid, *, scale, softcap, q_per_kv):
    b, h, c, hkv, d = _check_gqa_shapes(q, k, v, q_per_kv)
    q, k, v = _operands(q, k, v)
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 operands must be 16-byte aligned (cp.async)")
    mask, mask_bs = _mask_u8(valid, b, c, q.device)
    splits, per = split_plan(b, hkv, c, sm_count(q.device))
    n = b * h * splits
    scratch = torch.empty(n * (2 + d), dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    out = torch.empty_like(q)
    fn = _kernel_fn("gqa_split", q.dtype, _SPLIT_ARGS)
    rc = on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), mask_bs,
        b, c, h, hkv, d, splits, per, float(scale), float(softcap or 0.0),
        base, base + 4 * n, base + 8 * n, out.data_ptr(), stream))
    _check_rc(rc, "gqa_decode")
    return out


def _launch_gqa(q, k, v, valid, *, scale, softcap, q_per_kv):
    b, h, c, hkv, d = _check_gqa_shapes(q, k, v, q_per_kv)
    q, k, v = _operands(q, k, v)
    vmask = _mask(valid, b, c, q.device)
    heads, rows = partial_plan(q_per_kv, d, d, True, _GQA_ROWS)
    pm, pl, pa = _partials(b, h, c, d, rows, q.device)
    out = torch.empty_like(q)
    fn = _kernel_fn("gqa_decode", q.dtype, _GQA_ARGS)
    rc = on_device(q.device, lambda stream: fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vmask.data_ptr(), b, c, h,
        hkv, d, heads, rows, float(scale), float(softcap or 0.0),
        pm.data_ptr(), pl.data_ptr(), pa.data_ptr(), out.data_ptr(), stream))
    _check_rc(rc, "gqa_decode")
    return out


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor, *, scale: float, softcap: float = 0.0,
               q_per_kv: int = 1) -> torch.Tensor:
    """q (B,1,H,D); k/v (B,C,Hkv,D); valid (B or 1, C) bool → (B,1,H,D)
    in q's dtype. CUDA tensors run the kernel that ``gqa_route`` names,
    CPU tensors the plain version."""
    if q.device.type == "cuda":
        route = gqa_route(q.dtype, q_per_kv, q.shape[-1])
        launch = (_launch_gqa_split if route == "k_gqa_split"
                  else _launch_gqa)
        out = launch(q, k, v, valid, scale=scale, softcap=softcap,
                     q_per_kv=q_per_kv)
        gqa_decode.launches += 1
        gqa_decode.route_launches[route] += 1
        return out
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, scale=scale,
                                        softcap=softcap, q_per_kv=q_per_kv)
    raise ValueError(f"no decode attention route for device {q.device}")


gqa_decode.launches = 0
# the launches of each route by its first kernel's name
gqa_decode.route_launches = {"k_gqa_split": 0, "k_partial": 0}


def mla_route(dtype: torch.dtype, h: int, r: int, dr: int) -> str:
    """The kernel ``mla_decode`` launches on the card for a (dtype, heads,
    latent width R, rope width Dr): ``k_mla`` where its bf16 tensor-core
    tiles apply (R and Dr multiples of 16, R ≤ ``MLA_MAX_R``, Dr ≤
    ``MLA_MAX_DR``; any H), else ``k_partial``, which takes any shape."""
    if (dtype == torch.bfloat16 and r % 16 == 0 and dr % 16 == 0
            and 16 <= r <= MLA_MAX_R and 16 <= dr <= MLA_MAX_DR):
        return "k_mla"
    return "k_partial"


def mla_heads(h: int, r: int) -> int:
    """Heads a ``k_mla`` block holds (its hg, a multiple of 16): all H,
    padded to 16, where their f32 sums fit the registers — each of the 8
    warps holds hg × (its R / 8 columns) floats, at most 64 a thread (hg
    ≤ 64, and hg ≤ 32 for R > 256) — else the fewest equal groups that
    fit."""
    pairs = 1 if r <= 128 else 2 if r <= 256 else 4
    mt_max = min(4, 8 // pairs)
    mtiles = -(-h // 16)
    groups = -(-mtiles // mt_max)
    return 16 * -(-mtiles // groups)


def mla_smem_bytes(hg: int, r: int, dr: int, stages: int, tiles: int
                   ) -> int:
    """Shared memory of a ``k_mla`` block (the source's ``layout``): the
    queries and the ring of 64-row tiles in bf16 at a row stride of R + Dr
    + 8, the f32 scores and p's three bf16 terms at a stride of 72, each
    head's m, l and factor, and the tile list with its flags."""
    ks = r + dr + 8
    return (2 * hg * ks + 2 * stages * MLA_TILE * ks + 4 * hg * 72
            + 3 * 2 * hg * 72 + 4 * 3 * hg + 5 * tiles)


def mla_stages(hg: int, r: int, dr: int, tiles: int) -> int:
    """The ring's stages: 3 where a block's shared memory fits 227 KB,
    else 2 (raises when not even 2 fit)."""
    for stages in (3, 2):
        if mla_smem_bytes(hg, r, dr, stages, tiles) <= _SMEM_FLOATS * 4:
            return stages
    raise ValueError(f"k_mla: {hg} heads of R={r}, Dr={dr} with {tiles} "
                     f"tiles a split do not fit a block's shared memory")


def mla_split_plan(b: int, c: int, h: int, r: int, sms: int) -> tuple:
    """(splits, tiles per split) of ``k_mla``: split ``s`` of each
    (sequence, head group) walks tiles [s * per, min((s + 1) * per,
    tiles)) of ``MLA_TILE`` rows, none of them empty. One block of (split,
    head group, sequence) per SM, so at MiniCPM3-4B's 4 × 2048 rows one
    tile a split: on the card that beat 2, 4 and 8 tiles a split, though
    a split's partial (hg × R f32) then outweighs the ckv rows it reads
    (64 × R bf16) by up to hg / 32 ≤ 2."""
    tiles = -(-c // MLA_TILE)
    splits = -(-sms // (b * -(-h // mla_heads(h, r))))
    per = -(-tiles // max(1, min(tiles, splits)))
    return -(-tiles // per), per


def _check_mla_shapes(q_abs, q_rope, ckv, krope):
    b, one, h, r = q_abs.shape
    c, dr = ckv.shape[1], krope.shape[-1]
    if (one != 1 or tuple(q_rope.shape) != (b, 1, h, dr)
            or tuple(ckv.shape) != (b, c, r)
            or tuple(krope.shape) != (b, c, dr) or c < 1):
        raise ValueError(f"shapes q_abs {tuple(q_abs.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, "
                         f"krope {tuple(krope.shape)}")
    return b, h, c, r, dr


def _launch_mla_split(q_abs, q_rope, ckv, krope, valid, *, scale):
    b, h, c, r, dr = _check_mla_shapes(q_abs, q_rope, ckv, krope)
    q_abs, q_rope, ckv, krope = _operands(q_abs, q_rope, ckv, krope)
    if any(x.data_ptr() % 16 for x in (q_abs, q_rope, ckv, krope)):
        raise ValueError("bf16 operands must be 16-byte aligned (cp.async)")
    dev = q_abs.device
    mask, mask_bs = _mask_u8(valid, b, c, dev)
    hg = mla_heads(h, r)
    splits, per = mla_split_plan(b, c, h, r, sm_count(dev))
    stages = mla_stages(hg, r, dr, per)
    n = b * h * splits
    scratch = torch.empty(n * (2 + r), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    out = torch.empty_like(q_abs)
    fn = _kernel_fn("mla_split", q_abs.dtype, _MLA_SPLIT_ARGS, _MLA_SOURCE)
    rc = on_device(dev, lambda stream: fn(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), mask.data_ptr(), mask_bs, b, c, h, r, dr, hg,
        stages, splits, per, float(scale), base, base + 4 * n,
        base + 8 * n, out.data_ptr(), stream))
    _check_rc(rc, "mla_decode")
    return out


def _launch_mla(q_abs, q_rope, ckv, krope, valid, *, scale):
    b, h, c, r, dr = _check_mla_shapes(q_abs, q_rope, ckv, krope)
    q_abs, q_rope, ckv, krope = _operands(q_abs, q_rope, ckv, krope)
    vmask = _mask(valid, b, c, q_abs.device)
    heads, rows = partial_plan(h, r + dr, r, False, _MLA_ROWS)
    pm, pl, pa = _partials(b, h, c, r, rows, q_abs.device)
    out = torch.empty_like(q_abs)
    fn = _kernel_fn("mla_decode", q_abs.dtype, _MLA_ARGS)
    rc = on_device(q_abs.device, lambda stream: fn(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
        vmask.data_ptr(), b, c, h, r, dr, heads, rows, float(scale),
        pm.data_ptr(), pl.data_ptr(), pa.data_ptr(), out.data_ptr(), stream))
    _check_rc(rc, "mla_decode")
    return out


def mla_decode(q_abs: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               krope: torch.Tensor, valid: torch.Tensor, *, scale: float
               ) -> torch.Tensor:
    """q_abs (B,1,H,R), q_rope (B,1,H,Dr), ckv (B,C,R), krope (B,C,Dr),
    valid (B or 1, C) → latent context (B,1,H,R) in q_abs's dtype. CUDA
    tensors run the kernel that ``mla_route`` names, CPU tensors the plain
    version."""
    if q_abs.device.type == "cuda":
        route = mla_route(q_abs.dtype, q_abs.shape[2], q_abs.shape[-1],
                          q_rope.shape[-1])
        launch = _launch_mla_split if route == "k_mla" else _launch_mla
        out = launch(q_abs, q_rope, ckv, krope, valid, scale=scale)
        mla_decode.launches += 1
        mla_decode.route_launches[route] += 1
        return out
    if q_abs.device.type == "cpu":
        return ref.mla_decode_attention_ref(q_abs, q_rope, ckv, krope, valid,
                                            scale=scale)
    raise ValueError(f"no decode attention route for device {q_abs.device}")


mla_decode.launches = 0
# the launches of each route by its first kernel's name
mla_decode.route_launches = {"k_mla": 0, "k_partial": 0}
