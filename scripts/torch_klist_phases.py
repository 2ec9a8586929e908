"""Where the port's K-list kernel spends its time, phase by phase, at the 19
launches of one WaterRamps SymNet step on the bench scene (at the config's
precision: 18 launches of the bf16 variant and the fp32 ASCC conv).

    python -m scripts.torch_klist_phases

A diagnostic of ``dmcf_tpu_torch/csrc/cconv_klist.cu`` (with its tap walk
in ``csrc/klist_taps.cuh``), outside the package.  Builds the kernel as it
is and with parts cut out (by text substitution in the source or the
header, into ``dmcf_tpu_torch/_build/phases/<variant>/``; a cut whose text
is in neither stops the run), records the inputs of each launch
of one model step, and times every variant at each launch as device time
(CUDA-graph replay, no host launch gaps):

  full        the kernel as it is
  no_T        no T build: the launch, zeroing, barriers and epilogue (an
              empty tile mask also skips the filter product)
  no_product  T built, no filter product
  no_accum    taps and masks, no gather or accumulate: the product runs
              over the touched rows of a zero T

A variant's output is wrong by construction; only its time is read.  Needs
a CUDA device and nvcc; imports only the port.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch
import yaml

from dmcf_tpu_torch.kernels import build
from dmcf_tpu_torch.kernels.cconv_klist import is_bf16
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.profile_step import graph_ms, record_launches
from dmcf_tpu_torch.scene import bench_sample, build_scene

CUTS = {
    "full": [],
    "no_T": [("build_T<kTaps, kBF16>(p, sh.T, p.LD, sh.taps, sh.tmask, q0, "
              "s0, nr,\n                          clo, cw);", "")],
    "no_product": [("contract_fma(p, sh, nr, cw, base);", "(void)0;"),
                   ("contract_mma_bf16(p, sh, nr, cw, base, acc);",
                    "(void)0;"),
                   ("contract_mma(p, sh, nr, cw, base, acc);", "(void)0;")],
    "no_accum": [("while (bits) {", "while (false) {")],
}


def build_variants():
    """ctypes launchers of the kernel variants, by name."""
    files = ("cconv_klist.cu", "klist_taps.cuh")
    srcs = {f: (build.CSRC / f).read_text() for f in files}
    fns = {}
    for name, cuts in CUTS.items():
        texts = dict(srcs)
        for old, new in cuts:
            where = [f for f in files if old in texts[f]]
            if not where:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            texts[where[0]] = texts[where[0]].replace(old, new)
        out_dir = build.BUILD_DIR / "phases" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (out_dir / f).write_text(text)
        cu, so = out_dir / files[0], out_dir / f"{name}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        fn = ctypes.CDLL(str(so)).cconv_klist_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_klist_phases needs a CUDA device")
    dev = torch.device("cuda")
    fns = build_variants()
    with open(build.CSRC.parent.parent / "configs" / "WaterRamps.yml") as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    _, log = record_launches(model, bench_sample(*build_scene(), device=dev))
    totals = dict.fromkeys(fns, 0.0)
    print(f"device {torch.cuda.get_device_name(0)}; device ms per launch")
    for conv, (idx, a, t, feats, w, ksize), kw, _ in log:
        qf = kw.get("qfeats")
        half = is_bf16(kw.get("precision", "highest"))
        if half:  # the bf16 variant takes bf16 features and filter
            feats, w = feats.bfloat16(), w.bfloat16()
        q, k = idx.shape
        n, cin = feats.shape
        cout = w.shape[1]
        out = torch.empty((q, cout), device=dev)
        row = []
        for name, fn in fns.items():
            def call(fn=fn):
                fn(idx.data_ptr(), a.data_ptr(), t.data_ptr(),
                   feats.data_ptr(), None if qf is None else qf.data_ptr(),
                   w.data_ptr(), out.data_ptr(), q, k, n, cin, cout, *ksize,
                   int(half), torch.cuda.current_stream().cuda_stream)
            ms = graph_ms(call)
            totals[name] += ms
            row.append(f"{name} {ms:.4f}")
        print(f"{conv:11s} Q {q:4d} Cin {cin:2d} Cout {cout:2d} "
              f"sym {qf is not None:d} bf16 {half:d}: " + ", ".join(row))
    print("sum of the launches: "
          + ", ".join(f"{k} {v:.4f}" for k, v in totals.items()))


if __name__ == "__main__":
    main()
