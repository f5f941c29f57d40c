"""SHA-256 digests of the chain and cascade kernels' bytes on seeded inputs.

The exact path promises that a kernel's bytes depend on nothing but its
inputs: every FIR value is one ``__fmaf_rn`` chain over ``l = 0..T−1`` in
that order, every mixed sample the separately rounded steps of
``csrc/nco.cuh``.  So a kernel may be redesigned (tiles, threads, register
tiles, the way the phase is advanced) and must still give the same bytes.
:data:`PINNED` holds the digests of every output and every carry for the
cases below; ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
kernels to them on the card.

Cases: the chain at P/Q/T = 3/64/370, the cascade at the config-3 stages
(÷8 T = 65, 3/8 T = 51) and the 100 Msps split front (÷16 T = 85, ÷16
T = 95; float32 planes out), each at B = 256 and B = 16384 blocks of
L = 2048, i16 words in and out (the front: i16 in) and float32 planes in and
out, one stream (``C = 1``, the ``*_stream`` wrappers) and 16 channels (the
``*_channels`` wrappers), from non-zero carries.

Inputs come from ``numpy.random.default_rng`` and nothing else: the data,
the carries and the plan words themselves (any 64-bit ``D``, ``C1``, ``C2``
and any ``t`` in ``[0, L]`` are valid plan words, and the phase is a pure
function of them).  A third of the blocks switch segment inside the block,
a third never (``t = L``), the rest at once (``t = 0``).  The stream cases
run channel 0's plan words and carries.

The resampler's two kernels, ``csrc/window.cu`` (``window``) and
``csrc/conv.cu`` (``conv``), have cases of their own (:data:`RESAMPLE_CASES`):
seeded float32 ``[T−1 history | N inputs]`` buffers through the wrappers
``ops.resample.window_resample`` and ``ops.cuda.conv.resample_conv_stream``
at the arguments ``RationalResampler.process`` gives a chunk that starts at
input ``in_consumed`` of a stream — config 3's single stage at the
pipeline's chunk, at 2^24 inputs, mid-stream (``rem0``, ``p0`` ≠ 0, a
negative ``start0``), at 16 channels on strided, misaligned rows and at a
small buffer whose outputs run past both ends (the window form's clamp, the
conv form's zeros); the config-3 cascade's two stages on an EOF chunk; the
100 Msps split tail (P/Q = 384/3125) at the CLI's 2048 inputs a channel, one
channel and config 5's 256.  The digest is of ``stack([yi, yq])``.

    python -m doppler_tpu_torch.tools.kernel_digests            # print all
    python -m doppler_tpu_torch.tools.kernel_digests --check    # vs PINNED
    python -m doppler_tpu_torch.tools.kernel_digests --kernels window,conv

Digests are of the card's bytes; the plain versions sum the FIR in another
order and are not held to them.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys

import numpy as np
import torch

from doppler_tpu_torch.ops import codec, resample
from doppler_tpu_torch.ops.cuda import cascade, chain, conv
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import (
    RationalResampler,
    conv_stream_geometry,
    make_taps_matrix,
    window_dot,
    window_resample,
)

FS = 1_024_000
FS_SPLIT = 100_000_000
OUT_RATE = 48_000
L = 2048
C_MANY = 16
BLOCKS = (256, 16384)
KERNELS = ("chain", "cascade", "front")
RESAMPLE_KERNELS = ("window", "conv")

# Taken on the kernels as they stood before their redesign (one output a
# thread, 128-output tiles, a 64-bit division and a 64-bit product a sample),
# NVIDIA H100 80GB HBM3, CUDA 12.8.
PINNED: dict = {
    "cascade/B16384/f32/C1": {
        "out": "a3fd66ccebe0461f27e8b762dd4014db4aca18d5d41eb6b5d9a541330b48b268",
        "carries": [
            "802e3490da487beae098133818f509c38f9bc2b8d7a9c6b097858e827dbcabe0",
            "322e8c8ed97ddcfacf609c0116f6740b61d234c483b9ba73943b8faee12fe94c",
        ]},
    "cascade/B16384/f32/C16": {
        "out": "e89457f6345ff1bebc1d77ee0a4e37ced2b20306b13329d71a82bc2a0972407b",
        "carries": [
            "0d3ae4f368f97d2b8a29197a57e031dcfee3336cfe4ef19bf2dea7eab6e3acbe",
            "fe26a58dcbcbc39be60549f6c3d8e0e3bdd710070d93aa2ecf39b90d22c6294e",
        ]},
    "cascade/B16384/i16/C1": {
        "out": "fc4df8ec78e9657681e02c268f236772c57a22f848a297bc7ee13578eb28e6b5",
        "carries": [
            "729c80454d89044b70e02979f575e85dc2397c2498d304327a5149d67d94a889",
            "b58996d6025eff0d1c156105c6335703c09be8324bb0d24cd174739f369528da",
        ]},
    "cascade/B16384/i16/C16": {
        "out": "73291d423421adb87dec4ba99b81ddaaa8228a9befd71507275df35c42dc73f0",
        "carries": [
            "fe8d9067c95cc22c5a12513b9d3f4fb3d3325fa61d0fd3253c32e2be5eafa9bd",
            "9bd586337666d8aa0c6a770bf67c1bbcc2ef7b9514edd76af61fea58461788e3",
        ]},
    "cascade/B256/f32/C1": {
        "out": "633633e08c3cb93708ee3a6e1d7d49e6f7fa58e6456ec5bf7d82c539e4a49a3f",
        "carries": [
            "8a866d370f8dafd5fef391606ac197a3b7e8ba8745ef184658351381a7028241",
            "b18a1d38a5ecd39a6d3cf72b20240f1ce36ad87d52720398274550829a761761",
        ]},
    "cascade/B256/f32/C16": {
        "out": "db07d854b27bc4e79c5338f5f436950881fbf59bd05a131a506bcd9e954a14ea",
        "carries": [
            "0cfb0a5882d30441b07037927b24e887149316f398a56fe3eb6b7db432709109",
            "4c2eacc3aa4e687b71a13fb7c61f5b9877cdb6970be0a37357564ec181881acd",
        ]},
    "cascade/B256/i16/C1": {
        "out": "ffbfb584ab31d947e1c4aa33cfe7549724101855b53843c70b760496baf78979",
        "carries": [
            "212c2aab13d5e89cd374665cbefca9f9cbf5b18c9873c0cb8f3b22ba40e66bfe",
            "d367464d929ae1f31eda6f3ed29312ca3bf598a3f66b44a223eda4d25e5b45a1",
        ]},
    "cascade/B256/i16/C16": {
        "out": "4b0c6111de79df5d2a6438dece4936389df6af85b18fad738d5d6ee8052ff6c6",
        "carries": [
            "0b459a253d98b75d6b136d3a705197a36b67bc509a5dea7b70ccbbcd61580a00",
            "844439a57f75b42fc3845edbe56f1485839c7b89267a9982ad48e9e698ff31d3",
        ]},
    "chain/B16384/f32/C1": {
        "out": "ae494906061dd234d545803de5045541f674aa157d67f6ae4c868fb364363147",
        "carries": [
            "04ba80bb4e318648d5b96525a2f318869f7b7fcdd87e8f21be6716df876f218e",
        ]},
    "chain/B16384/f32/C16": {
        "out": "d2e36cee4721a72619f30ad1b35e10c2e1a4149e9ed35e69a6126202a9024540",
        "carries": [
            "adccabec25789d3dfc812f7eb7606b1885bea00bbf28ede1908d44c8b5a1baf2",
        ]},
    "chain/B16384/i16/C1": {
        "out": "8efc43bb97b2b2ba68594cdc8effeaa4aa8fba2c14fea6b2032582710f9bb9c6",
        "carries": [
            "6d499372c6f01839e670e6eed62109857827c4f8729647910cc24bd76457d4c2",
        ]},
    "chain/B16384/i16/C16": {
        "out": "b308a372b29208b87ae3dcb53f5c96480b3b5b9efa28c38de3c441185f9d4fe5",
        "carries": [
            "f07451149b468b14a13044b3b198a306dcccbb4f1dc310198ef8bb3c2a28249a",
        ]},
    "chain/B256/f32/C1": {
        "out": "978563e90f44e69500451578b327c114c54389b1cd72db4b5c65b789624bb251",
        "carries": [
            "5109f9ddbd233a050269308ef4be0d24d50c93c9e18dff40de962541551e3eec",
        ]},
    "chain/B256/f32/C16": {
        "out": "00e202745680bbe1981810df99ba8511e1f8e46790397b1c4fcfb7bab1e68024",
        "carries": [
            "fd3470c146d21976ea67be81c95eb82d896a9dd42fcb13e6753fe04c1c78355b",
        ]},
    "chain/B256/i16/C1": {
        "out": "261c9c31a2ad8fcc3413c11af9643ff5d5ca620f971602772c4702c13128d4de",
        "carries": [
            "eb81a10ec30e132af153481d8b2eca330d0bf93d55ecab2098c5f1d70a4b4e55",
        ]},
    "chain/B256/i16/C16": {
        "out": "52691c8e62f3d989fde73a0ec077c83a64a92f9706026539ddb88f5c897a60c8",
        "carries": [
            "862e6b7649ba9ba2fbbae5febccc4bd77ee9fb5d2f0a2482a25e7d3f9f3d1f0a",
        ]},
    "front/B16384/f32/C1": {
        "out": "2e082ee98690ad56e42acefd0320f945b6b8bc186450506b5f38d1f277d5a50a",
        "carries": [
            "3b87b6ca92d5951153d20c06407b2e92af4f0c9f29fafd3a0b92f5a513d6cfb5",
            "c30b7c2cc7b03dd1d946a96f8e7161bb8cfdde820bac18a425db901fe06dbb13",
        ]},
    "front/B16384/f32/C16": {
        "out": "515be8c3c28d207439bc69d0410be96dcfd8a6f9cda89e27bdfbebdb77c06b3f",
        "carries": [
            "698d88d48e5f65b0c11c86f2513d8f060b5eed9fc2d026feace969e42af5ba2c",
            "31cd507d60e7a62e3ff36abd7767d248627dfc43f9e17277220e76df7eecc169",
        ]},
    "front/B16384/i16/C1": {
        "out": "0d21cdf616db62aa39bec2f7d0b87c18c63699462db9d9d684ba27de15c7cbe1",
        "carries": [
            "6c21148a8596bed894ab3d97bb6cc6380eef4b9dfe87b82dffa8eb9805a31d09",
            "fec1b8be303204c41c399902031503c2155d2c0e1752e8ad3b49c2601361ac91",
        ]},
    "front/B16384/i16/C16": {
        "out": "00473f4b4c9ebc453fd7c1d774a5776baeb41086ddfcd40902971658a2cd67f3",
        "carries": [
            "03654d3d4c8479a27786aabb9000b63be74b9a376281944d4be53443ae039e2d",
            "37747f8d480fa52ff4b8e805aaa6f0cb77d18ea65e63bf36b8dff64fd16e8c95",
        ]},
    "front/B256/f32/C1": {
        "out": "701659156ca096110a3fdf9204151f84bc2032f09d70f781f26fc35fdfd88d90",
        "carries": [
            "9b5004d35fdfed859baccbf3c7e078b959571c109fe24b30eacd7caaadd396ad",
            "b41ad539ce0ad9dc00b282bb8b84592344ff070181c5f054a4ac5e57dcf32832",
        ]},
    "front/B256/f32/C16": {
        "out": "60e2623b7ddd68da592c3fe9d37af7343ac3c7a4b397d6b1d8ca9ff7b576005a",
        "carries": [
            "7e64ed6722261e5b4dcde836c2f90ce431346755ff6c33ea78fd4bf27e9e443a",
            "1ad391efbc13205f9eb09d0308ad190cb34103b540950d6ef9922694ea5ff94b",
        ]},
    "front/B256/i16/C1": {
        "out": "78b1ca6ec4233b22305f25ab0993333eeef0051e27c22b9d45e8af2c92aa459c",
        "carries": [
            "08792191fe6adf0e02409b0c20ba68b2557f80856f86a48b3c37ca7e35781bbd",
            "baffb1351dabf7a5767f2af8acd0f5f515359454efa94faae9d97428d2b1cc77",
        ]},
    "front/B256/i16/C16": {
        "out": "83617c16ef8a225a975f3a3d32540464a3e66a82b9be7f72779f21e452323bb9",
        "carries": [
            "f0cfc79b68db0d2e4302f9a182ab17cd8d3313ac65f95aef08c55f85bac777de",
            "d9a19308b00d99568afe38fc151e709f51d59fbeb47ff408cf7570e241f6d623",
        ]},
}

# The resampler kernels' cases, taken on csrc/window.cu and csrc/conv.cu as
# they stood before their redesign (one thread an output-plane, a chain of
# L1 loads), NVIDIA H100 80GB HBM3, 700.00 W, nvcc 12.9.86, torch
# 2.11.0+cu128.
PINNED.update({
    "conv/c3-2p24/C1":
        "3590506a058bef8e328cd3e6d9281d64946f2a37ce851f0587b09327dbefc0a1",
    "conv/c3-chunk/C1":
        "09ba1ecc01685b93f45ec534dd58593ad05bd3e5172be0cbd141d244768b8da3",
    "conv/c3-edge/C1":
        "0be064cdae2c4141eea40345de526001c8e5dc0b1a56ab4d42dcb16f9eb39d01",
    "conv/c3-mid/C1":
        "5ef9fe55ce651dd1a05467da4a4083fd90c2fc1710bd59f78a632e27cd222d1f",
    "conv/c3-mid/C16":
        "1acf31c87a5cbb7927edf0c254f621d00af35f541ff6780e5a4f26bbe90e3a3d",
    "conv/c38-s0/C1":
        "95cfadeca075bf7878729326c16c66aec02b1838e5948f54d763cdd30f1b48d3",
    "conv/c38-s1/C1":
        "9e43fd02ebdb6ca34921f9cab6b15c0cf362dae51f152d75024c4289d05a5dff",
    "conv/tail/C1":
        "f3012ad41d4571218b7c387dde3f649ae6d5445dacba20b70003ecf8d895682d",
    "conv/tail/C256":
        "1e92bebf73db7fcd3a26f7896beabbef1a9dae4f867816a8da9649d4a99b4c59",
    "window/c3-2p24/C1":
        "3ed6b1041e8cd0937ffc8663e3d44e57449f05193359d23389d68dbd177a0e62",
    "window/c3-chunk/C1":
        "882f325d81720c15e8e80ff207a1ac7ef803d285f4f766f4fc87ef47a45c563a",
    "window/c3-edge/C1":
        "783d7b217a17bc6c11f144076466a429f472f9be23bd798fbca93a20175d59e4",
    "window/c3-mid/C1":
        "e8d462c6dc079e5f16a6e8c8c0eaafd96962b4e941823c2f2eb29d60c9112368",
    "window/c3-mid/C16":
        "c49c8d94ea7d5c32708ab7b458476ca06a01e8d41ca291e1e86611ee3521100b",
    "window/c38-s0/C1":
        "cdea9ded1dfe741d1a86e06ac30a92827a266ceab4d4effa11f39bc78ce8d4b5",
    "window/c38-s1/C1":
        "08304b2eb5b68462ea185abb3e24ab9990b51a44243fb4b1bf8bba663c650d5f",
    "window/tail/C1":
        "8df5515ca108f705120db161e9b9fd446d21c0319280c80aad0d59882ee21f70",
    "window/tail/C256":
        "01001ee058490be08811a4f6b6ca0ad35c612bf01d7c3889c9eab81a722b7db7",
})

def case_name(kernel: str, B: int, fmt: str, C: int) -> str:
    return f"{kernel}/B{B}/{fmt}/C{C}"


def seeded_inputs(B: int, fmt: str, C: int = C_MANY):
    """``(data, plans)`` as NumPy arrays: int32 words ``(B, L)`` or float32
    planes ``(2, B, L)``, and int32 plan words ``(7, C, B)``."""
    rng = np.random.default_rng([B, int(fmt == "f32"), C])
    if fmt == "i16":
        data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                            dtype=np.int64).astype(np.int32)
    else:
        data = (rng.standard_normal((2, B, L), dtype=np.float32)
                * np.float32(0.3))
    plans = rng.integers(0, 1 << 32, size=(7, C, B),
                         dtype=np.uint64).astype(np.uint32)
    kind = rng.integers(0, 3, size=(C, B))
    inside = rng.integers(1, L, size=(C, B))
    plans[6] = np.where(kind == 0, inside, np.where(kind == 1, L, 0))
    return data, plans.view(np.int32)


def seeded_carries(stages, C: int = C_MANY):
    """One ``(C, 2, T−1)`` float32 carry per stage of ``stages``."""
    rng = np.random.default_rng([len(stages), C] + [v for st in stages for v in st])
    return [(rng.standard_normal((C, 2, T - 1), dtype=np.float32)
             * np.float32(0.3)) for _, _, T in stages]


def geometry(kernel: str):
    """``(stages, banks)`` of a kernel's case, banks as NumPy arrays."""
    if kernel == "chain":
        rs = RationalResampler(FS, OUT_RATE)
        return ((rs.P, rs.Q, rs.T),), [rs.bank]
    ms = MultiStageResampler(FS if kernel == "cascade" else FS_SPLIT, OUT_RATE)
    fused = ms.stages[:cascade.split_point(ms.stages)]
    return (tuple((st.P, st.Q, st.T) for st in fused),
            [st.bank for st in fused])


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def run_case(kernel: str, fmt: str, C: int, data, plans, device) -> dict:
    """Launch one case on ``device`` tensors ``data`` and ``(7, C_MANY, B)``
    ``plans``; returns ``{"out": sha, "carries": [sha per stage]}``."""
    stages, banks = geometry(kernel)
    banks = [torch.from_numpy(b).to(device) for b in banks]
    carries = [torch.from_numpy(c).to(device) for c in seeded_carries(stages)]
    outtype = "f32" if kernel == "front" else fmt
    if C == 1:
        plans = plans[:, 0].contiguous()
        carries = [c[0].contiguous() for c in carries]
    else:
        plans = plans[:, :C].contiguous()
        carries = [c[:C].contiguous() for c in carries]
    if kernel == "chain":
        (P, Q, T), = stages
        fn = (chain.mix_resample_chain_stream if C == 1
              else chain.mix_resample_chain_channels)
        out, c_out = fn(data, plans, banks[0], carries[0], P=P, Q=Q, T=T,
                        intype=fmt, outtype=outtype)
        c_out = [c_out]
    else:
        fn = (cascade.mix_cascade_stream if C == 1
              else cascade.mix_cascade_channels)
        out, c_out = fn(data, plans, banks, carries, stages=stages, intype=fmt,
                        outtype=outtype, final_dense=kernel == "front")
    return {"out": _sha(out), "carries": [_sha(c) for c in c_out]}


def compute(blocks=BLOCKS, kernels=KERNELS, channels=(1, C_MANY),
            fmts=("i16", "f32"), device="cuda") -> dict:
    """Digests of the cases at the block counts ``blocks``, by case name."""
    device = torch.device(device)
    res = {}
    for B in blocks:
        for fmt in fmts:
            data, plans = seeded_inputs(B, fmt)
            data = torch.from_numpy(data).to(device)
            plans = torch.from_numpy(plans).to(device)
            for kernel in kernels:
                for C in channels:
                    res[case_name(kernel, B, fmt, C)] = run_case(
                        kernel, fmt, C, data, plans, device)
    return res


# -- the resampler's kernels (csrc/window.cu, csrc/conv.cu) ------------------------

CHUNK = 256 * L                    # the pipeline's chunk: 256 blocks of 2048
TAIL_CHUNK = CHUNK // 256          # the split tail's inputs a chunk (÷256 front)


@dataclasses.dataclass(frozen=True)
class ResampleCase:
    """One resampler step: ``stage`` is ``(in_rate, index)`` of a stage of
    ``MultiStageResampler(in_rate, OUT_RATE)`` (index None: the single-stage
    ``RationalResampler``); C channels of ``[T−1 | N]`` samples, the chunk
    starting at input ``in_consumed`` of the stream at output ``m0``
    (None: the stream's own, ⌈in_consumed·P/Q⌉); M outputs, ``extra``
    beyond the resampler's capacity ``N·P//Q + 2``; ``strided``: rows of a
    wider, misaligned buffer."""
    stage: tuple
    C: int
    N: int
    in_consumed: int
    m0: int | None = None
    extra: int = 0
    strided: bool = False


RESAMPLE_CASES = {
    "c3-chunk/C1": ResampleCase((FS, None), 1, CHUNK, 0),
    "c3-2p24/C1": ResampleCase((FS, None), 1, 1 << 24, 0),
    "c3-mid/C1": ResampleCase((FS, None), 1, CHUNK, 7 * CHUNK + 5),
    "c3-mid/C16": ResampleCase((FS, None), 16, 1 << 16, 3 * (1 << 16) + 11,
                               strided=True),
    # start0 = −2Q−1, p0 = 2; the window form's off0 = −87: both ends
    "c3-edge/C1": ResampleCase((FS, None), 1, 3000, 769, m0=32, extra=40),
    "c38-s0/C1": ResampleCase((FS, 0), 1, CHUNK, 39 * CHUNK),
    "c38-s1/C1": ResampleCase((FS, 1), 1, CHUNK // 8 + 2, 39 * CHUNK // 8 + 5),
    "tail/C1": ResampleCase((FS_SPLIT, 2), 1, TAIL_CHUNK, 95 * TAIL_CHUNK),
    "tail/C256": ResampleCase((FS_SPLIT, 2), 256, TAIL_CHUNK, 95 * TAIL_CHUNK),
}


def resample_stage(case: ResampleCase):
    """``(P, Q, T, bank)`` of a case's stage, the bank as a NumPy array."""
    fs, index = case.stage
    rs = (RationalResampler(fs, OUT_RATE) if index is None
          else MultiStageResampler(fs, OUT_RATE).stages[index])
    return rs.P, rs.Q, rs.T, rs.bank


def resample_args(case: ResampleCase, P: int, Q: int, T: int) -> dict:
    """The host ints of a case: M, the window form's ``(rem0, off0)`` and the
    conv form's ``conv_stream_geometry``, as ``RationalResampler.process``
    computes them."""
    m0 = (-(-case.in_consumed * P // Q) if case.m0 is None else case.m0)
    M = case.N * P // Q + 2 + case.extra
    start0, p0, K, PADZ, TAIL = conv_stream_geometry(
        m0, case.in_consumed, M, case.N, P=P, Q=Q, T=T)
    return dict(m0=m0, M=M, rem0=(m0 * Q) % P,
                off0=(m0 * Q) // P - case.in_consumed, start0=start0, p0=p0, K=K,
                PADZ=PADZ, TAIL=TAIL)


def resample_inputs(name: str, device):
    """``(xi, xq)`` of a case on ``device``: seeded float32 rows, ``(n,)``
    for one channel, ``(C, n)`` else (views of wider rows, one float in,
    where the case is ``strided``)."""
    case = RESAMPLE_CASES[name]
    _, _, T, _ = resample_stage(case)
    n = T - 1 + case.N
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    width = n + 13 if case.strided else n
    planes = []
    for _ in range(2):
        x = (rng.standard_normal((case.C, width), dtype=np.float32)
             * np.float32(0.3))
        t = torch.from_numpy(x).to(device)
        t = t[:, 1:1 + n] if case.strided else t
        planes.append(t[0] if case.C == 1 else t)
    return planes


def resample_step(kernel: str, name: str, device, layout=None, plain=False):
    """A zero-argument call of ``kernel``'s wrapper on case ``name``'s
    inputs (made once, on ``device``), returning ``(yi, yq)``.  ``layout``:
    the kernel's launch at that path and those sizes
    (``ops.resample._window_launch``, ``ops.cuda.conv._launch``); ``plain``:
    its plain version (``window_dot``, ``resample_conv_stream_plain``) on
    the same inputs."""
    case = RESAMPLE_CASES[name]
    P, Q, T, bank = resample_stage(case)
    a = resample_args(case, P, Q, T)
    xi, xq = resample_inputs(name, device)
    if kernel == "window":
        bank_rev = torch.from_numpy(bank[:, ::-1].copy()).to(device)
        args = (xi, xq, bank_rev, a["rem0"], a["off0"])
        kw = dict(P=P, Q=Q, T=T, M=a["M"])
        if plain:
            return lambda: window_dot(*args, **kw)
        if layout is not None:
            return lambda: resample._window_launch(*args, **kw, layout=layout)
        return lambda: window_resample(*args, **kw)
    taps = torch.from_numpy(make_taps_matrix(bank, P, Q)).to(device)
    args = (xi, xq, taps, a["start0"], a["p0"])
    kw = dict(P=P, Q=Q, T=T, **{k: a[k] for k in ("K", "M", "PADZ", "TAIL")})
    if plain:
        return lambda: conv.resample_conv_stream_plain(*args, **kw)
    if layout is not None:
        return lambda: conv._launch(*args, P=P, Q=Q, T=T, M=a["M"], layout=layout)
    return lambda: conv.resample_conv_stream(*args, **kw)


def resample_vs_plain(kernel: str, name: str, device) -> dict:
    """``kernel`` against its plain version on case ``name``'s inputs, over
    the outputs whose inputs lie in the buffer: the largest float32 error
    and its tolerance (window 2^-20, as the chain kernel; conv 1e-5 of the
    plain version's peak), and after encoding to i16 the largest LSB
    difference and the share of words that differ.  ``ok``: within the
    tolerance, ≤ 1 LSB in under 1%."""
    case = RESAMPLE_CASES[name]
    P, Q, T, _ = resample_stage(case)
    a = resample_args(case, P, Q, T)
    n = max(0, min(-(-(case.in_consumed + case.N) * P // Q) - a["m0"], a["M"]))
    got, want = (torch.stack(resample_step(kernel, name, device, plain=p)())
                 .reshape(2, -1, a["M"])[..., :n] for p in (False, True))
    tol = 2.0 ** -20 if kernel == "window" else 1e-5 * want.abs().max().item()
    err = (got - want).abs().max().item()
    words = [codec.iq_to_i16_words(y[0].reshape(-1), y[1].reshape(-1))
             .view(torch.int16).int() for y in (got, want)]
    d = (words[0] - words[1]).abs()
    lsb, frac = int(d.max().item()), float((d > 0).float().mean().item())
    return dict(max_abs_err=err, tol=tol, lsb=lsb, frac=frac,
                ok=err <= tol and lsb <= 1 and frac < 0.01)


def compute_resample(kernels=RESAMPLE_KERNELS, cases=None,
                     device="cuda") -> dict:
    """Digests of the resampler kernels' cases, by ``kernel/case`` name."""
    device = torch.device(device)
    res = {}
    for name in (cases or RESAMPLE_CASES):
        for kernel in kernels:
            yi, yq = resample_step(kernel, name, device)()
            res[f"{kernel}/{name}"] = _sha(torch.stack([yi, yq]))
    return res


def mismatches(got: dict) -> list:
    """Names of the cases of ``got`` whose digests differ from :data:`PINNED`
    (a case that is not pinned counts as a mismatch)."""
    return [name for name, d in got.items() if PINNED.get(name) != d]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default=",".join(map(str, BLOCKS)))
    ap.add_argument("--kernels", default=",".join(KERNELS + RESAMPLE_KERNELS),
                    help="comma-separated, of "
                         f"{', '.join(KERNELS + RESAMPLE_KERNELS)}")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every digest equals the pinned one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) fails without a card; on cpu the "
                         "plain versions run, whose bytes are not the pinned")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    unknown = [k for k in names if k not in KERNELS + RESAMPLE_KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown}")
    fir = tuple(k for k in KERNELS if k in names)
    got = (compute(tuple(int(b) for b in args.blocks.split(",")), kernels=fir,
                   device=args.device) if fir else {})
    got.update(compute_resample(tuple(k for k in RESAMPLE_KERNELS if k in names),
                                device=args.device))
    print(json.dumps(got, indent=1, sort_keys=True))
    if args.check:
        bad = mismatches(got)
        print(f"{len(got) - len(bad)} of {len(got)} cases equal the pinned "
              f"digests; differing: {bad}", file=sys.stderr)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
