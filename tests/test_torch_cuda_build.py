"""The kernel library's build (``cook_tpu_torch/ops/cuda_lib.build``)
when processes start it together, as a topology's shard workers and a
node's standby beside its leader do.

There is no ``nvcc`` here, so a stand-in compiler takes its place on the
``PATH``: ``-c`` writes its object slowly (a head, a pause, a tail), and
``-shared`` links only whole objects, failing on a half-written one.
Two processes wait for each other, then build into one empty directory:
both must return the same library, the objects compiled once and linked
whole.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
        log.write(("link" if "-shared" in args else "compile") + " "
                  + os.path.basename(out) + "\\n")
    if "-shared" in args:
        data = b""
        for obj in args[args.index("-o") + 2:]:
            body = open(obj, "rb").read()
            if not body.endswith(b"END\\n"):
                sys.exit("half-written object " + obj)
            data += body
        open(out, "wb").write(data)
        sys.exit(0)
    src = args[args.index("-c") + 1]
    with open(out, "wb") as f:
        f.write(b"OBJ " + os.path.basename(src).encode() + b"\\n")
        f.flush()
        time.sleep(1.0)
        f.write(b"END\\n")
    ''')

BUILDER = textwrap.dedent('''\
    import os, sys, time
    from pathlib import Path
    from cook_tpu_torch.ops import cuda_lib
    cuda_lib.BUILD_DIR = Path(sys.argv[1])
    me, other = Path(sys.argv[2]), Path(sys.argv[3])
    me.touch()
    deadline = time.time() + 60
    while not other.exists() and time.time() < deadline:
        time.sleep(0.01)
    print(cuda_lib.build(), cuda_lib.LAST_BUILD["built"])
    ''')


def test_concurrent_builds_share_one_sound_library(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build" / "cuda"
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO), FAKE_NVCC_LOG=str(log))
    ready = [tmp_path / "ready0", tmp_path / "ready1"]
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILDER, str(build_dir), str(ready[i]),
         str(ready[1 - i])], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    (path0, built0), (path1, built1) = (o.split() for o, _e in outs)
    assert path0 == path1
    assert sorted([built0, built1]) == ["False", "True"]
    sources = sorted(p.name for p in
                     (REPO / "cook_tpu_torch/ops/csrc").glob("*.cu"))
    lib = Path(path0).read_bytes()
    objs = [chunk for chunk in lib.split(b"END\n") if chunk]
    assert sorted(o.split()[1].decode() for o in objs) == sources
    calls = log.read_text().split("\n")
    assert sum(c.startswith("compile") for c in calls) == len(sources)
    assert sum(c.startswith("link") for c in calls) == 1
    assert (build_dir / ".build.lock").exists()
