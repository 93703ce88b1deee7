"""What users launch, on the port's `System`: the dataset drivers (EuRoC,
TUM-VI, KITTI, TUM-RGBD), the synthetic and multi-robot runs and the
extraction demo.  Each runs as ``python -m
orbslam3_tpu_torch.examples.<name>`` and on the card unless given
``--device cpu``; images are read with `utils.imageio`, so no cv2 is
needed."""
