"""``python -m repro_torch.launch.train --devices N`` on the CPU: N gloo
ranks (``launch.mesh.spawn``) on the reference's grid, ``(N // 2, 2)`` over
``(data, model)`` from 4 on, else ``(N,)`` over ``data``; checkpoints of
full tensors that resume on another grid or on one device.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def test_launcher_over_devices_runs_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --devices 4`` trains qwen3-32b's
    smoke config on the ``(2, 2)`` grid over gloo with a checkpoint;
    ``--devices 2`` resumes it on ``(2,)`` (elastic), and one device
    resumes that (in process)."""
    from repro_torch.launch import train as launcher
    args = ["--device", "cpu", "--smoke", "--arch", "qwen3-32b", "--batch",
            "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for devices, steps in ((4, 2), (2, 4)):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--devices", str(devices), "--steps", str(steps)], env=env,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        runs.append(out.stdout)
    assert "mesh: {'data': 2, 'model': 2} over gloo" in runs[0]
    assert "finished 2 steps" in runs[0] and "resumed" not in runs[0]
    assert "resumed step 2 onto {'data': 2} (elastic)" in runs[1]
    assert "finished 2 steps" in runs[1]
    assert runs[1].count("finished") == 1          # rank 0 prints
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    launcher.main(args + ["--steps", "5"])
    again = capsys.readouterr().out
    assert "resumed step 4" in again and "finished 1 steps" in again
