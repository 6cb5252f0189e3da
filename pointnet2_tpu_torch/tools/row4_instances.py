#!/usr/bin/env python3
"""Row 4 (the multi-radius ball query, csrc/ball_query.cu): its instances
a radius count against one instance for every count.

Builds csrc/ball_query.cu as the port does, and a copy of it whose
``pn2_ball_query_multi`` always launches the eight-radius instance, the
radii it is not given closed by nsample 0 (the copy's epilogue skips
their counts), under the same ``__launch_bounds__``; prints the copy's
``ptxas -v`` lines. Then, on the ball-query inputs of the MSG layers of
pointnet2_cls_msg and pointnet2_part_seg_msg_one_hot at B=16 (the
FPS chain of chip_smoke.py's clouds), times both builds with CUDA events
(200 back-to-back launches, the queue pre-filled), in the order
instances, one instance, one instance, instances, two rounds; checks that
both give the same idx and cnt.

Usage, from the repository root, on one NVIDIA H100:

    python3 pointnet2_tpu_torch/tools/row4_instances.py [out.json]
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def one_instance_source(src: str) -> str:
    """csrc/ball_query.cu with every radius count sent to the kMaxRadii
    instance."""
    a = src.index("  switch (count) {")
    b = src.index("  }\n  return cudaGetLastError();\n}", a)
    out = (src[:a] + "  launch_multi<kMaxRadii>(xyz1, xyz2, p, n, m, "
           "qtiles, blocks, s);\n" + src[b + 4:])
    old = "    if (lane == 0) p.cnt[i][q] = c;"
    if old not in out:
        raise RuntimeError("csrc/ball_query.cu's row-4 epilogue changed")
    return out.replace(old, "    if (lane == 0 && ns > 0) p.cnt[i][q] = c;")


def main() -> int:
    sys.path.insert(0, _ROOT)
    import torch

    import chip_smoke as cs
    from pointnet2_tpu_torch.ops import _build, grouping

    if not torch.cuda.is_available():
        print("row4_instances: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    _build.build_all()
    tmp = tempfile.mkdtemp(prefix="row4_")
    src = os.path.join(tmp, "ball_query_one.cu")
    with open(src, "w") as f:
        f.write(one_instance_source(
            (_build.CSRC / "ball_query.cu").read_text()))
    lib_path = os.path.join(tmp, "ball_query_one.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-Xptxas", "-v",
                           "-I", str(_build.CSRC), "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        return 1
    print("ptxas of the one-instance build:")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print("  ", line.strip())
    fn = ctypes.CDLL(lib_path).pn2_ball_query_multi
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch_one(radii, xyz1, xyz2, outs):
        B, N, _ = xyz1.shape
        count = len(outs)
        err = fn(xyz1.data_ptr(), xyz2.data_ptr(),
                 (ctypes.c_float * count)(*[grouping._r2(r) for r in radii]),
                 (ctypes.c_int * count)(*[i.shape[2] for i, _ in outs]),
                 (ctypes.c_void_p * count)(*[i.data_ptr() for i, _ in outs]),
                 (ctypes.c_void_p * count)(*[c.data_ptr() for _, c in outs]),
                 count, B, N, xyz2.shape[1], grouping._stream(xyz1))
        if err:
            raise RuntimeError(f"one-instance launch failed: {err}")

    dev = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    print(gpu, torch.__version__)
    levels = cs.msg_levels(
        torch, dev, cs.make_clouds(16, cs.N_POINT, cs.SEED + 1),
        cs.make_clouds(16, cs.PART_N, cs.SEED + 12, normals=True))
    rounds, same = [], True
    for _ in range(2):
        rows = []
        for lv in levels:
            xyz, new = lv["xyz"], lv["new_xyz"]
            B, M = new.shape[:2]
            radii = lv["radii"]

            def buffers():
                return tuple((torch.empty((B, M, ns), dtype=torch.int32,
                                          device=dev),
                              torch.empty((B, M), dtype=torch.int32,
                                          device=dev))
                             for ns in lv["nsamples"])

            a, b = buffers(), buffers()
            calls = {"instances": lambda: grouping.launch_ball_query_multi(
                         radii, xyz, new, a),
                     "one": lambda: launch_one(radii, xyz, new, b)}
            ms = {k: [] for k in calls}
            for k in ("instances", "one", "one", "instances"):
                ms[k].append(cs.event_ms(torch, calls[k], 200, prefill=True))
            torch.cuda.synchronize()
            same = same and all(torch.equal(x, y) and torch.equal(u, v)
                                for (x, u), (y, v) in zip(a, b))
            rows.append({"model": lv["model"], "tag": lv["tag"],
                         "radii": list(radii), **ms})
            print(f"  {lv['tag']} radii {radii}: instances {ms['instances']}"
                  f" ms, one instance {ms['one']} ms")
        for model in (cs.CLS_MSG, cs.PART_MSG):
            tot = {k: sum(min(r[k]) for r in rows if r["model"] == model)
                   for k in ("instances", "one")}
            print(f"  {model}: instances {tot['instances']:.6f} ms, one "
                  f"instance {tot['one']:.6f} ms, "
                  f"{tot['one'] / tot['instances']:.2f}x")
        rounds.append(rows)
    print(f"same idx and cnt: {same}")
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"gpu": gpu, "rounds": rounds, "same": same}, f)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
