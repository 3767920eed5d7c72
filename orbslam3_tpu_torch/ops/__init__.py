"""Front-end compute: pyramid, FAST (+ the CUDA FAST/NMS kernel), BRIEF,
Hamming distances."""
