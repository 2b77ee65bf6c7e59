"""The benchmark's frozen road scene against the program's device
renderer (``DeviceSyntheticSource``), on the CPU: the same frames, bit
for bit, for a few seeds and sizes."""
import pytest
import torch

from roadbench.frames import RoadScene


@pytest.mark.parametrize("seed,w,h,vehicles", [
    (0, 160, 96, 6), (3, 320, 180, 24), (2 ** 31 + 5, 192, 108, 11)])
def test_scene_equals_device_source(seed, w, h, vehicles, cpu):
    from roadvision_tpu_torch.io_video import DeviceSyntheticSource
    src = DeviceSyntheticSource(w, h, num_vehicles=vehicles, seed=seed,
                                device=cpu)
    scene = RoadScene(w, h, vehicles, seed, cpu)
    idx = torch.tensor([0, 1, 17, 63, 640])
    assert torch.equal(scene.render_at(idx), src.render_at(idx))
