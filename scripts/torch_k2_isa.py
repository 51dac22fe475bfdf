"""What the card's compiler makes of K2 and K2b, per order: registers and
spills (`nvcc -Xptxas -v`), the SASS of every loop (`cuobjdump -sass`) and
the clusters the card holds at once (`cudaOccupancyMaxActiveClusters`) of
each order's kernel at every site of args256syn128 and args256syn64s2d.

    python3 scripts/torch_k2_isa.py [--root DIR ...] [--out DIR]

For each checkout in `--root` (this one by default; for example the parent
commit unpacked with `git archive` beside it), compiles
`anoddpm_torch/csrc/group_norm_silu.cu` and `group_norm_silu_backward.cu`
with the port's flags to a cubin, and writes under `--out`
(build/isa by default) the SASS and, per checkout, one JSON (the
cubins and the probe libraries stay in a temporary directory): per
kernel instantiation its registers and spill bytes, and its loops (a branch
back to an earlier address), each with its length and its count of
instructions by kind (MUFU, conversions F2F/F2FP/PRMT, FP32 arithmetic,
integer, loads and stores, branches).  A loop with a 16-byte global store
(STG.E.128) is a pass that writes the output: its length over the elements
of the vector (8 bf16, 4 fp32) is its SASS per element.  The clusters per
instantiation come from a small library built from a source that includes
the checkout's `.cu` and calls its `prepare_kernel` on each instantiation
with the plan of every site (the flax order's bf16 kernels with their
table's shared memory where the checkout stages one).  The plans are read
from each checkout's own wrapper and compared.  Run from the root of a
checkout on a machine with a card and `nvcc`.
"""
import argparse
import collections
import ctypes
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("group_norm_silu", "group_norm_silu_backward")
CONFIGS = ("256syn128", "256syn64s2d")
KINDS = {
    "mufu": ("MUFU",),
    "convert": ("F2F", "F2FP", "F2I", "I2F", "PRMT"),
    "fp32": ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FCHK"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "IMNMX", "VIMNMX", "SEL",
            "LEA", "IABS", "MOV", "SHL", "SHR"),
    "load": ("LDS", "LDG", "LD", "LDSM", "LDC", "ULDC"),
    "store": ("STS", "STG", "ST"),
    "branch": ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT", "WARPSYNC"),
}
# the include-probe: each order's kernel at T through the checkout's own
# `prepare_kernel`; EXTRA is the flax order's table bytes where it has one
PROBE = {
    "group_norm_silu": """
#include "{src}"
template <typename T, int O>
int k2(int cluster, int threads, int smem, int* out) {{
  return (int)prepare_kernel(group_norm_silu_kernel<T, O>, cluster, threads,
                             smem + {extra}, out);
}}
extern "C" int probe(int dtype, int order, int variant, int c, int cluster,
                     int threads, int smem, int* out) {{
  (void)variant; (void)c;
  if (dtype == 0)
    return order ? k2<float, 1>(cluster, threads, smem, out)
                 : k2<float, 0>(cluster, threads, smem, out);
  return order ? k2<__nv_bfloat16, 1>(cluster, threads, smem, out)
               : k2<__nv_bfloat16, 0>(cluster, threads, smem, out);
}}
""",
    "group_norm_silu_backward": """
#include "{src}"
template <typename T, int O>
int k2b(int c, int cluster, int threads, int smem, int* out) {{
  return (int)prepare_kernel(group_norm_silu_bwd_kernel<T, O>, cluster,
                             threads, dynamic_smem(c, smem) + {extra}, out);
}}
template <typename T>
int k2b_t(int o, int c, int cluster, int threads, int smem, int* out) {{
  if (o == 0) return k2b<T, 0>(c, cluster, threads, smem, out);
  if (o == 1) return k2b<T, 1>(c, cluster, threads, smem, out);
  return k2b<T, 2>(c, cluster, threads, smem, out);
}}
extern "C" int probe(int dtype, int order, int variant, int c, int cluster,
                     int threads, int smem, int* out) {{
  const int o = order ? 1 + variant : 0;
  return dtype == 0 ? k2b_t<float>(o, c, cluster, threads, smem, out)
                    : k2b_t<__nv_bfloat16>(o, c, cluster, threads, smem, out);
}}
""",
}


def port_modules(root, alias):
    """The checkout's `ops.group_norm_silu` and `ops._build`, imported as
    package `alias`."""
    pkg = os.path.join(root, "anoddpm_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.group_norm_silu"),
            importlib.import_module(f"{alias}.ops._build"))


def compile_flags(build):
    """The port's nvcc flags without those of a shared library."""
    flags, skip = [], False
    for f in build.NVCC_FLAGS:
        if skip:
            skip = False
        elif f == "-Xcompiler":
            skip = True
        elif f != "-shared":
            flags.append(f)
    return flags


def ptxas_info(log):
    """{mangled function: {"registers", "spill_stores", "spill_loads"}}."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return out


def kind_counts(ops):
    counts = collections.Counter()
    for op in ops:
        base = op.split(".")[0]
        kind = next((k for k, names in KINDS.items() if base in names), "other")
        counts[kind] += 1
    counts["total"] = len(ops)
    return dict(counts)


def sass_functions(text):
    """{mangled function: ([(address, opcode, full instruction)], {label:
    address of the instruction after it})}."""
    funcs, current, pending = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current, pending = m.group(1), []
            funcs[current] = ([], {})
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and current:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and current:
            ins = m.group(2).strip()
            words = ins.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                addr = int(m.group(1), 16)
                funcs[current][0].append((addr, words[0], ins))
                for label in pending:
                    funcs[current][1][label] = addr
                pending = []
    return funcs


def loops(instrs, labels):
    """Every branch back to an earlier address: (start, end, opcodes,
    whether it holds a 16-byte global store)."""
    index = {addr: i for i, (addr, _, _) in enumerate(instrs)}
    out = []
    for i, (addr, op, ins) in enumerate(instrs):
        m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", ins)
        if op.startswith("BRA") and m:
            target = (labels.get(m.group(1)) if m.group(1)
                      else int(m.group(2), 16))
            if target is not None and target < addr and target in index:
                body = instrs[index[target]:i + 1]
                out.append((target, addr, [o for _, o, _ in body],
                            any(o.startswith("STG.E.128") for _, o, _ in body)))
    return out


def demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    return dict(zip(names, res.stdout.splitlines()))


def isa(root, build, out_dir, work, tag):
    """Registers, spills and loops of every kernel of both sources."""
    nvcc = build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    result = {}
    for name in SOURCES:
        src = os.path.join(root, "anoddpm_torch", "csrc", f"{name}.cu")
        cubin = os.path.join(work, f"{tag}-{name}.cubin")
        res = subprocess.run([nvcc, *compile_flags(build), "-cubin",
                              "-Xptxas", "-v", "-o", cubin, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {src}:\n{res.stderr}")
        info = ptxas_info(res.stderr + res.stdout)
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
        with open(os.path.join(out_dir, f"{tag}-{name}.sass"), "w") as f:
            f.write(sass)
        funcs = sass_functions(sass)
        names = demangle(sorted(set(funcs) | set(info)))
        for mangled, (instrs, labels) in funcs.items():
            result[names.get(mangled, mangled)] = {
                **info.get(mangled, {}), "instructions": len(instrs),
                "loops": [dict(start=hex(a), end=hex(b), stores_output=st,
                               **kind_counts(ops))
                          for a, b, ops, st in loops(instrs, labels)
                          if len(ops) >= 20]}
    return result


def site_plans(gn, sites):
    """{(kind, shape, dtype name): plan tuple} of both kernels at `sites`."""
    out = {}
    for kind, n in (("forward", 4), ("backward", 8)):
        for shape, dtype in sites:
            c, hw = shape[1], math.prod(shape[2:])
            p = (gn.plan if kind == "forward" else gn.backward_plan)(n, c, hw, dtype)
            out[(kind, (n,) + tuple(shape[1:]), str(dtype)[6:])] = tuple(p)
    return out


def clusters(root, build, work, tag, plans):
    """Each order's max active clusters at every plan, from the include-probe
    libraries."""
    nvcc = build.nvcc_path()
    libs = {}
    for name in SOURCES:
        src = os.path.join(root, "anoddpm_torch", "csrc", f"{name}.cu")
        text = open(src).read()
        extra = ("table_smem<T, O>()" if "table_smem" in text else "0")
        probe_src = os.path.join(work, f"{tag}-{name}-probe.cu")
        with open(probe_src, "w") as f:
            f.write(PROBE[name].format(src=src, extra=extra))
        lib = os.path.join(work, f"{tag}-{name}-probe.so")
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-I",
                        os.path.dirname(src), "-o", lib, probe_src], check=True)
        libs[name] = ctypes.CDLL(lib)
        libs[name].probe.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)]
    out = {}
    for (kind, shape, dtype), p in sorted(plans.items(), key=str):
        lib = libs["group_norm_silu" if kind == "forward"
                   else "group_norm_silu_backward"]
        code = 0 if dtype == "float32" else 1
        per = {}
        orders = [("kernel", 0, 0), ("flax", 1, 0)] + (
            [("flax bf16_path", 1, 1)] if kind == "backward" else [])
        for label, order, variant in orders:
            count = ctypes.c_int(-1)
            status = lib.probe(code, order, variant, shape[1], p[0], p[2], p[3],
                               ctypes.byref(count))
            per[label] = count.value if status == 0 else f"error {status}"
        out[f"{kind} {shape} {dtype} plan {p}"] = per
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="+", default=[HERE])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "isa"))
    opts = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_isa: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from anoddpm_torch.config import load_args
    os.makedirs(opts.out, exist_ok=True)
    chip_smoke.device_info()
    sites = []
    for config in CONFIGS:
        args = load_args(config, config_dir=os.path.join(HERE, "configs"))
        model = chip_smoke.seeded_model(args)
        sites += chip_smoke.k2_sites(model)
        del model
    sites = sorted(set(sites), key=str)
    sites += [(s, torch.float32) for s, dt in sites if dt != torch.float32]
    plans_of, summary = {}, {}
    for i, root in enumerate(os.path.abspath(r) for r in opts.root):
        tag = "this" if root == HERE else f"root{i}"
        gn, build = port_modules(root, f"isa_port{i}")
        plans_of[tag] = site_plans(gn, sites)
        with tempfile.TemporaryDirectory() as work:
            report = {"root": root,
                      "isa": isa(root, build, opts.out, work, tag),
                      "clusters": clusters(root, build, work, tag,
                                           plans_of[tag])}
        with open(os.path.join(opts.out, f"{tag}.json"), "w") as f:
            json.dump(report, f, indent=1)
        summary[tag] = root
        for fn, r in report["isa"].items():
            print(f"{tag} {fn}: {r.get('registers')} registers, spills "
                  f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} B, "
                  f"{r['instructions']} instructions; loops "
                  + "; ".join(f"{l['total']}{'*' if l['stores_output'] else ''}"
                              f" (mufu {l.get('mufu', 0)}, cvt "
                              f"{l.get('convert', 0)}, fp32 {l.get('fp32', 0)})"
                              for l in r["loops"]), flush=True)
        for key, per in report["clusters"].items():
            print(f"{tag} clusters {key}: {per}", flush=True)
    tags = list(plans_of)
    same = all(plans_of[t] == plans_of[tags[0]] for t in tags)
    print(f"plans equal across the checkouts at {len(plans_of[tags[0]])} "
          f"(kernel, shape, dtype): {same}")
    print(json.dumps({"roots": summary, "plans_equal": same,
                      "out": os.path.relpath(opts.out, HERE)}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
