"""Run a module as one rank of a ``torchrun`` launch, refusing any write by a
rank other than 0 under a watched directory:

    torchrun --standalone --nproc_per_node=N tools/torch_rank_audit.py <dir> <module> [args...]

A file opened for writing or a directory created under ``<dir>`` by such a
rank raises ``PermissionError`` (through an audit hook), so that rank, and
the launch, fail with the path in the error.
"""

import os
import runpy
import sys

WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND


def main() -> None:
    watched = os.path.realpath(sys.argv[1])
    module = sys.argv[2]
    sys.argv = [module] + sys.argv[3:]
    rank = os.environ.get("RANK", "0")

    def hook(event, args):
        if event == "open":
            path, writes = args[0], bool((args[2] or 0) & WRITE)
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove"):
            path, writes = args[0], True
        else:
            return
        if writes and isinstance(path, (str, bytes, os.PathLike)):
            real = os.path.realpath(os.fsdecode(path))
            if real == watched or real.startswith(watched + os.sep):
                raise PermissionError(f"rank {rank} writes {real}")

    if rank != "0":
        sys.addaudithook(hook)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runpy.run_module(module, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
