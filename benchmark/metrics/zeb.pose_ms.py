"""`zeb.pose_ms`: host ms a pair from entering `eval/zeb.pair_metrics`
(epipolar errors, `geometry/pose.estimate_pose`: RANSAC and recoverPose,
pose errors) to the batch's metric rows being on the host, summed over
the whole window. The span `zeb.pose` also names the pose in the trace's
idle gaps."""

SPANS = {"zeb.pose": "gim_tpu_torch.eval.zeb:pair_metrics"}


def read(t):
    s = t.host_s.get("zeb.pose", 0.0)
    return s * 1e3 / t.window_pairs if s > 0 and t.window_pairs else None
