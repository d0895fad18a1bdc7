"""Global bundle adjustment over the keyframe map, on one device (port of
the single-device part of vins_tpu/parallel: dist_ba.solve_ba and the
harvest from the keyframe DB; the landmark-sharded solve is not ported)."""
