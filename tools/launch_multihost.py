"""Multi-process launcher for bds3_tpu distributed runs.

The reference receiver is a single MATLAB process; this launcher is the
new framework's process-spawn story for `jax.distributed` runs
(SURVEY.md section 2.5, parallel/multihost.py).  Two backends:

  local   — spawn N co-located processes, one per local card (rank r
            sees only card r through CUDA_VISIBLE_DEVICES), or on the
            CPU with --cpu (CI / laptop; what tests/test_multihost.py
            drives).
  slurm   — emit (or submit with --submit) an sbatch script where each
            task initializes jax.distributed from SLURM_* variables.

Both run the SAME user program: it calls
`bds3_tpu.parallel.multihost.initialize()` (env-driven) and then builds
its global mesh.

Usage:
  python tools/launch_multihost.py local --nproc 4 -- \
      python my_receiver.py --channels 48
  python tools/launch_multihost.py local --cpu --nproc 2 -- \
      python my_receiver.py --channels 24
  python tools/launch_multihost.py slurm --nodes 4 [--submit] -- \
      python my_receiver.py
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local(nproc: int, cmd: list[str], local_devices: int = 1,
                 env_extra: dict | None = None, cpu: bool = True) -> int:
    """Spawn nproc local processes with jax.distributed env plumbing.

    Sets JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID,
    which `bds3_tpu.parallel.multihost.initialize()` reads.  cpu=True
    keeps every rank on the CPU with `local_devices` virtual devices;
    cpu=False gives rank r the single card CUDA_VISIBLE_DEVICES=r, so no
    two processes share a card.  Returns the first nonzero child exit
    code (0 if all succeeded)."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = str(nproc)
        env["JAX_PROCESS_ID"] = str(rank)
        if cpu:
            env["JAX_PLATFORMS"] = "cpu"
            # deterministic per-process device count: replace any
            # inherited host-platform flag rather than deferring to it
            flags = " ".join(
                f for f in env.get("XLA_FLAGS", "").split()
                if "xla_force_host_platform_device_count" not in f)
            env["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_devices}").strip()
        else:
            # one card per process: a JAX process reserves most of a
            # card's memory, so two ranks must never share one
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        env.update(env_extra or {})
        procs.append(subprocess.Popen(cmd, env=env))
    rc = 0
    for p in procs:
        r = p.wait()
        rc = rc or r
    return rc


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name=bds3
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive

# rank 0's node is the coordinator
COORD_HOST=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export JAX_COORDINATOR_ADDRESS="$COORD_HOST:{port}"
export JAX_NUM_PROCESSES="$SLURM_NTASKS"

srun --export=ALL bash -c '
  export JAX_PROCESS_ID="$SLURM_PROCID"
  exec {cmd}
'
"""


def emit_slurm(nodes: int, cmd: list[str], port: int = 8476) -> str:
    return SBATCH_TEMPLATE.format(nodes=nodes, port=port,
                                  cmd=" ".join(shlex.quote(c) for c in cmd))


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="backend", required=True)

    p_local = sub.add_parser("local")
    p_local.add_argument("--nproc", type=int, default=2)
    p_local.add_argument("--cpu", action="store_true",
                         help="run every rank on the CPU instead of one "
                              "card per rank")
    p_local.add_argument("--local-devices", type=int, default=1,
                         help="virtual CPU devices per process (--cpu)")
    p_local.add_argument("cmd", nargs=argparse.REMAINDER)

    p_slurm = sub.add_parser("slurm")
    p_slurm.add_argument("--nodes", type=int, required=True)
    p_slurm.add_argument("--port", type=int, default=8476)
    p_slurm.add_argument("--submit", action="store_true")
    p_slurm.add_argument("cmd", nargs=argparse.REMAINDER)

    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing program to launch (append: -- python ...)")

    if args.backend == "local":
        t0 = time.time()
        rc = launch_local(args.nproc, cmd, args.local_devices, cpu=args.cpu)
        print(f"[launch] {args.nproc} local processes finished "
              f"rc={rc} in {time.time()-t0:.1f}s", file=sys.stderr)
        return rc
    if args.backend == "slurm":
        script = emit_slurm(args.nodes, cmd, args.port)
        if args.submit:
            r = subprocess.run(["sbatch"], input=script.encode())
            return r.returncode
        print(script)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
