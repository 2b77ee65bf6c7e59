"""The plain reference the benchmark judges the program against.

Plain PyTorch (float32, TF32 off, on the card where the run has one) and
NumPy, written from the published descriptions and the checkpoints'
layouts: the preprocess chain (OpenCV's YCrCb fixed point, CLAHE, a 3×3
median), the letterbox or stretch resize, YOLOv8 and RT-DETR-L forwards,
their NMS or top-k selection, SORT and the homography geometry. It
imports neither JAX nor anything of the program, and takes nothing the
program made: it reads the checkpoint file and the frames the benchmark
rendered, and works out everything else again.
"""
