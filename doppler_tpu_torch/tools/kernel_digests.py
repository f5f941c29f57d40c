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

    python -m doppler_tpu_torch.tools.kernel_digests            # print all
    python -m doppler_tpu_torch.tools.kernel_digests --check    # vs PINNED

Digests are of the card's bytes; the plain versions sum the FIR in another
order and are not held to them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

from doppler_tpu_torch.ops.cuda import cascade, chain
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import RationalResampler

FS = 1_024_000
FS_SPLIT = 100_000_000
OUT_RATE = 48_000
L = 2048
C_MANY = 16
BLOCKS = (256, 16384)
KERNELS = ("chain", "cascade", "front")

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


def mismatches(got: dict) -> list:
    """Names of the cases of ``got`` whose digests differ from :data:`PINNED`
    (a case that is not pinned counts as a mismatch)."""
    return [name for name, d in got.items() if PINNED.get(name) != d]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default=",".join(map(str, BLOCKS)))
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every digest equals the pinned one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) fails without a card; on cpu the "
                         "plain versions run, whose bytes are not the pinned")
    args = ap.parse_args(argv)
    got = compute(tuple(int(b) for b in args.blocks.split(",")),
                  device=args.device)
    print(json.dumps(got, indent=1, sort_keys=True))
    if args.check:
        bad = mismatches(got)
        print(f"{len(got) - len(bad)} of {len(got)} cases equal the pinned "
              f"digests; differing: {bad}", file=sys.stderr)
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
