"""Mutation check of the CUDA kernels against `chip_smoke.py` phase 3.

Each mutant is a copy of the checkout, in a temporary directory, whose
`csrc/paged_attention.cu`, `csrc/grouped_gemm.cu`, `csrc/kv_transfer.cu`,
`csrc/vision_attention.cu` or `csrc/ring_attention.cu` carries one planted
fault.  Every copy builds
its own kernels (in parallel), then runs phase 3 alone; phase 3 must fail
with "kernel disagrees".  A mutant of the re-page between tp groups must
also fail phase 16 (b)'s byte check, run in its copy on a transfer made in
process (`chip_smoke.window_probe_main`).  A mutant of the engine's
partitioned dispatch (`engine/engine.py`) is checked by phase 17's probe
instead (`chip_smoke.py --dp-probe`: a partitioned dp 2 group against a
flat engine), which must report problems; a mutant of a group's media
(`engine/media.py`) by phase 18 (b)'s (`chip_smoke.py --vl-probe`: a
partitioned dp 2 group serving Qwen2.5-VL-7B's images and video against
a flat engine), and a mutant of the decode ring (`parallel/pipeline.py`)
by phase 19 (a)'s (`chip_smoke.py --pp-probe`: a pp 2 group against the
flat engine), and a mutant of the sequence-parallel ring (its rotation
in `parallel/ring_attention.py`, its kernel's causal mask in
`csrc/ring_attention.cu`) by phase 20 (a)'s (`chip_smoke.py --sp-probe`:
an sp 4 group against the flat engine).  The card runs need a CUDA card:

    python3 -m dynamo_tpu_torch.mutants            # every mutant
    python3 -m dynamo_tpu_torch.mutants NAME ...   # some of them

The media and ring mutants (`CPU_CHECKED`) are also checked on the CPU,
where their test file must fail in a copy of the package that carries
the fault (one whose card probe cannot see it is checked there only; the
ring kernel's mask, which no CPU test runs, through its plain twin's):

    python3 -m dynamo_tpu_torch.mutants --cpu [NAME ...]

Prints one JSON line per mutant (caught or not, and each case's error
relative to its tolerance, or for the byte-exact re-page cases the count
of differing elements), then exits 1 if any mutant went unseen.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("dynamo_tpu_torch", "csrc")
PA, GG, KT = "paged_attention.cu", "grouped_gemm.cu", "kv_transfer.cu"
VA = "vision_attention.cu"
# the engine and its media, relative to the kernel sources
ENGINE = os.path.join("..", "engine", "engine.py")
MEDIA = os.path.join("..", "engine", "media.py")
PIPELINE = os.path.join("..", "parallel", "pipeline.py")
RING = os.path.join("..", "parallel", "ring_attention.py")
RING_OPS = os.path.join("..", "ops", "ring_attention.py")
RA = "ring_attention.cu"

# name -> (source file, a text of it, its faulty replacement); each text
# occurs once
MUTANTS = {
    "merge ignores the split maxima": (
        PA, "      const float f = exp2f(ms - M);\n",
        "      const float f = 1.f;\n"),
    "merge drops the last split": (
        PA, "  for (int s = 0; s < n_split; ++s) {\n    const float ms",
        "  for (int s = 0; s < n_split - 1; ++s) {\n    const float ms"),
    # Qwen2's groups (7, 6): with the group itself, not its power-of-two
    # ceiling, 14 or 12 lanes share a key and the shuffle tree and the
    # 16-byte slices no longer cover hd (the phase-3 G 7 and G 6 cases;
    # groups 1, 2, 4 and 8 are unchanged)
    "decode lane split sized from G, not its power-of-two ceiling": (
        PA, "  constexpr int GP = pow2_ceil(G);\n", "  constexpr int GP = G;\n"),
    "prefill reads the wrong kv head": (
        PA, "  const size_t col = (size_t)kh * HD + lc * 8;",
        "  const size_t col = (size_t)((kh + 1) % n_kv) * HD + lc * 8;"),
    "prefill leaves the diagonal tile unmasked": (
        PA, "const bool need_mask = window > 0 || u0 + NKEYS - 1 > pre + q0;",
        "const bool need_mask = window > 0;"),
    "grouped GEMM reads the next expert's weights": (
        GG, "n0 + nb * BOX, k0, e);",
        "n0 + nb * BOX, k0, (e + 1) % E);"),
    "grouped GEMM drops the last K tile": (
        GG, "const int kt1 = min(KT, kt0 + kt_per_slice);",
        "const int kt1 = min(KT - 1, kt0 + kt_per_slice);"),
    "grouped GEMM shifts a tile's rows by one": (
        GG, "const int row0 = lo + (t - first) * BM;",
        "const int row0 = lo + (t - first) * BM + (t > first);"),
    # the router's N = 32 and the last column tile of N = 2880 have such
    # columns
    "grouped GEMM stores columns past N over the first ones": (
        GG, "      const int col = col_a + 8 * j;\n      if (col >= N) continue;\n",
        "      int col = col_a + 8 * j;\n      if (col >= N) col %= N;\n"),
    "epilogue adds the next expert's bias": (
        GG, "const size_t brow = (size_t)e * N;",
        "const size_t brow = (size_t)((e + 1) % E) * N;"),
    "fused epilogue drops the gate clamp": (
        GG, "    g = fminf(g, 7.f);\n", ""),
    "fused epilogue swaps gate and up": (
        GG, "__floats2bfloat162_rn(moe_act(act, v0, u0), moe_act(act, v1, u1))",
        "__floats2bfloat162_rn(moe_act(act, u0, v0), moe_act(act, u1, v1))"),
    "split-K sum drops the last slice": (
        GG, "for (int z = 1; z < S; ++z)", "for (int z = 1; z < S - 1; ++z)"),
    # the KV re-page (the pages a case reads never include the pool's
    # last, so the next page id stays inside it)
    "re-page reads the next source page": (
        KT, "const int sp = src_pages[t / ps_s];",
        "const int sp = src_pages[t / ps_s] + 1;"),
    "re-page copies past prompt_len instead of zeros": (
        KT, "    if (t >= prompt_len) {\n      zero8(out);\n      continue;\n    }\n",
        ""),
    "re-page counts destination tokens in source pages": (
        KT, "const int t = j * ps_d + s;", "const int t = j * ps_s + s;"),
    # the re-page between tp groups: a window read one head off (the
    # windowed cases; a whole row read one head off reads the next
    # token's first head)
    "re-page shifts the source head window by one head": (
        KT, "const int src_off = src_head * hd, dst_off = dst_head * hd;",
        "const int src_off = (src_head + 1) * hd, dst_off = dst_head * hd;"),
    # the towers' segment attention (the windowed and CLIP cases have more
    # than one segment; 4784 and 577 are not multiples of the 64-key tile,
    # and the windows hold at most 64 patches: every timed case ends in a
    # partial key tile)
    "segment tile reads keys past its segment's end": (
        VA, "k1 = min(tl.w, n_tok);", "k1 = min(tl.w + NK, n_tok);"),
    "segment skips the last partial key tile": (
        VA, "const int n_tiles = (k1 - k0 + NK - 1) / NK;",
        "const int n_tiles = (k1 - k0) / NK;"),
    "segment drops the hi.lo pass of Q.K^T": (
        VA, "    issue_s_pass(sb + SM::QHI, klo, false);\n", ""),
    "segment V^T transpose writes key j into column j + 1": (
        VA, "const int key = col_key(4 * c + i);",
        "const int key = (col_key(4 * c + i) + NK - 1) % NK;"),
    "segment leaves the zero-filled keys of the last tile unmasked": (
        VA, "        if (8 * j + 2 * t4 + (e & 1) >= n_valid) s[j][e] = NEG_INF;\n", ""),
    # a partitioned dp dispatch: replica 1 takes replica 0's rows of the
    # LOCAL page table (its own tokens and positions), so it reads and
    # writes another partition's page ids in its pool
    "partitioned dispatch hands replica 1 replica 0's page table": (
        ENGINE, "        return {k: t[lo:lo + n] for k, t in d.items()}\n",
        "        return {k: t[(0 if k == 'table' and self._pooled else lo):][:n]\n"
        "                for k, t in d.items()}\n"),
    # a dp group's prefill with media: replica 1 splices the media rows of
    # replica 0's block into its own rows (and none of its own)
    "replica 1 receives replica 0's block of media rows": (
        MEDIA, "    lo, n = span\n", "    lo, n = 0, span[1]\n"),
    # a group's prefill plan without the rows' M-RoPE streams: the
    # followers rope a media row text-style, the leader by its streams
    "followers rope a media row text-style (the plan drops the M-RoPE streams)": (
        MEDIA, '    if "pos" in mm:\n        out["pos"] = mm["pos"]\n', ""),
    # the decode ring: stage 0 drops the token the last stage hands back
    # and feeds each microbatch its previous step's token again
    "the ring hands stage 0 the previous step's token": (
        PIPELINE, "                feed[gp % M] = recv\n",
        "                feed[gp % M] = feed[gp % M]\n"),
    # the sp ring: slot i is told its round-r block came from (i + r) mod
    # N where the rotation hands it (i - r) mod N's (the keys' positions,
    # and so the causal mask, are another block's)
    "the sp ring hands each slot the block of (i + r) mod N": (
        RING, "    return [(slot - r) % n for r in range(n)]\n",
        "    return [(slot + r) % n for r in range(n)]\n"),
    # the ring kernel's causal mask without the diagonal (no query sees
    # its own key), and its plain twin, the CPU's ring
    "the ring kernel's causal mask is < instead of <=": (
        RA, "return u < nk && (!causal || kp <= qp)",
        "return u < nk && (!causal || kp < qp)"),
    "the plain ring's causal mask is < instead of <=": (
        RING_OPS, "    mask = kp <= qp if causal else torch.ones_like(kp <= qp)\n",
        "    mask = kp < qp if causal else torch.ones_like(kp <= qp)\n"),
    # the ring kernel's pool route: it reads a key's page as a fresh
    # pool lays out a single row (page index + 1) and not through the
    # table (right for phase 3's ordered pages, wrong after churn: its
    # permuted pages), or finds a key's place in its page with a mask
    # (right for pages of a power of two, wrong for its pages of 48)
    "the ring kernel reads a key's page as in a fresh pool, not the table": (
        RA, "slot = (size_t)spid[min(pidx - pg0, n_pg - 1)] * page + (u - pidx * page);",
        "slot = (size_t)(pidx + 1) * page + (u - pidx * page);"),
    "the ring kernel finds a key's place in its page with a mask": (
        RA, "slot = (size_t)spid[min(pidx - pg0, n_pg - 1)] * page + (u - pidx * page);",
        "slot = (size_t)spid[min(pidx - pg0, n_pg - 1)] * page + (u & (page - 1));"),
}

_BUILD = "from dynamo_tpu_torch.ops import _build; _build.build_all()"
_PHASE3 = "import chip_smoke; chip_smoke.phase_kernels()"
# the mutants phase 16 (b)'s byte check must see too
_WINDOW_PROBE = "import sys, chip_smoke; sys.exit(chip_smoke.window_probe_main())"
BYTE_CHECKED = ("re-page shifts the source head window by one head",)
# the mutants phase 17's dp probe must see (phase 3 runs no engine)
_DP_PROBE = "import sys, chip_smoke; sys.argv[1:] = ['--dp-probe']; sys.exit(chip_smoke.main())"
DP_CHECKED = ("partitioned dispatch hands replica 1 replica 0's page table",)
# the mutants phase 18 (b)'s vision probe must see
_VL_PROBE = "import sys, chip_smoke; sys.argv[1:] = ['--vl-probe']; sys.exit(chip_smoke.main())"
VL_CHECKED = ("replica 1 receives replica 0's block of media rows",)
# the mutants phase 19 (a)'s pipeline probe must see
_PP_PROBE = "import sys, chip_smoke; sys.argv[1:] = ['--pp-probe']; sys.exit(chip_smoke.main())"
PP_CHECKED = ("the ring hands stage 0 the previous step's token",)
# the mutants phase 20 (a)'s sequence-parallel probe must see
_SP_PROBE = "import sys, chip_smoke; sys.argv[1:] = ['--sp-probe']; sys.exit(chip_smoke.main())"
SP_CHECKED = ("the sp ring hands each slot the block of (i + r) mod N",
              "the ring kernel's causal mask is < instead of <=")
# the engine mutants the CPU tests must see: name -> the test file that
# fails in a copy carrying the fault.  Dropping the M-RoPE streams moved
# phase 18 (b)'s probe rows only within a near-tie (0.44 std at 2 layers
# on an H100), so the CPU tests, which hold a group's tokens to JAX's
# exactly, are its check.
CPU_CHECKED = {
    "replica 1 receives replica 0's block of media rows":
        os.path.join("tests", "test_torch_tp_vision.py"),
    "followers rope a media row text-style (the plan drops the M-RoPE streams)":
        os.path.join("tests", "test_torch_tp_vision.py"),
    "the ring hands stage 0 the previous step's token":
        os.path.join("tests", "test_torch_pp.py"),
    "the sp ring hands each slot the block of (i + r) mod N":
        os.path.join("tests", "test_torch_sp.py"),
    "the plain ring's causal mask is < instead of <=":
        os.path.join("tests", "test_torch_sp.py"),
}
CARD_CHECKED = [n for n in MUTANTS
                if n not in CPU_CHECKED or n in VL_CHECKED or n in PP_CHECKED
                or n in SP_CHECKED]


def _copy(name: str) -> str:
    source, old, new = MUTANTS[name]
    tmp = tempfile.mkdtemp(prefix="pa_mutant_")
    shutil.copytree(os.path.join(ROOT, "dynamo_tpu_torch"),
                    os.path.join(tmp, "dynamo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
    path = os.path.join(tmp, CSRC, source)
    with open(path) as f:
        src = f.read()
    if src.count(old) != 1:
        raise RuntimeError(f"mutant {name!r}: its text occurs {src.count(old)} times")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    return tmp


def _py(code: str, cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=900)


def cpu_main(names) -> int:
    """Each named mutant of `CPU_CHECKED` (all by default) in a copy of
    the package beside links to this checkout's JAX package and tests:
    its test file must fail there (pytest's exit code 1: tests ran and
    some failed)."""
    missed = 0
    for n in names or list(CPU_CHECKED):
        tmp = _copy(n)
        try:
            for link in ("dynamo_tpu", "tests"):
                os.symlink(os.path.join(ROOT, link), os.path.join(tmp, link))
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", CPU_CHECKED[n], "-q",
                 "-p", "no:cacheprovider"], cwd=tmp, capture_output=True,
                text=True, timeout=1800, env={**os.environ,
                                              "JAX_PLATFORMS": "cpu"})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        failed = [ln.split()[1] for ln in proc.stdout.splitlines()
                  if ln.startswith("FAILED ")]
        caught = proc.returncode == 1 and bool(failed)
        missed += not caught
        print(json.dumps({"mutant": n, "caught": caught, "rc": proc.returncode,
                          "failed": failed}), flush=True)
    return 1 if missed else 0


def probe_verdict(stdout: str, key: str, rc: int):
    """(caught, report) of a card probe's run: caught only when the probe
    printed its JSON line and that line names problems.  A probe that
    crashed, or ended without its line, missed the mutant: a crash is no
    proof that the probe's comparison saw the fault."""
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith('{"%s"' % key)]
    if not lines:
        return False, {"rc": rc, "printed": False}
    probe = lines[-1][key]
    return rc == 0 and bool(probe.get("problems")), probe


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if argv[:1] == ["--cpu"]:
        return cpu_main(argv[1:])
    names = argv or CARD_CHECKED
    dirs = {n: _copy(n) for n in names}
    try:
        with ThreadPoolExecutor(max_workers=len(names)) as ex:
            builds = dict(zip(names, ex.map(lambda n: _py(_BUILD, dirs[n]), names)))
        missed = 0
        for n in names:
            if builds[n].returncode != 0:
                raise RuntimeError(f"mutant {n!r} did not build:\n{builds[n].stderr[-3000:]}")
            probe = None
            for checked, code, key in ((DP_CHECKED, _DP_PROBE, "dp_probe"),
                                       (VL_CHECKED, _VL_PROBE, "vl_probe"),
                                       (PP_CHECKED, _PP_PROBE, "pp_probe"),
                                       (SP_CHECKED, _SP_PROBE, "sp_probe")):
                if n not in checked:
                    continue
                p2 = _py(code, dirs[n])
                caught, probe = probe_verdict(p2.stdout, key, p2.returncode)
                missed += not caught
                print(json.dumps({"mutant": n, "caught": caught,
                                  key: probe}), flush=True)
            if probe is not None:
                continue
            proc = _py(_PHASE3, dirs[n])  # one at a time: phase 3 times kernels
            cases = [json.loads(ln) for ln in proc.stdout.splitlines()
                     if ln.startswith('{"phase": "kernel_check"')]
            caught = proc.returncode != 0 and "kernel disagrees" in proc.stderr
            if n in BYTE_CHECKED:
                p2 = _py(_WINDOW_PROBE, dirs[n])
                lines = [json.loads(ln) for ln in p2.stdout.splitlines()
                         if ln.startswith('{"window_probe"')]
                probe = lines[-1]["window_probe"] if lines else {"rc": p2.returncode}
                caught = caught and bool(probe.get("differing_elements"))
            missed += not caught
            print(json.dumps({
                "mutant": n, "caught": caught, "window_probe": probe,
                "rel_err_over_tol": {c["case"]: (c["max_rel_err"] / c["rtol"]
                                                 if c["rtol"] else c["max_rel_err"])
                                     for c in cases},
                "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
            }), flush=True)
        return 1 if missed else 0
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
