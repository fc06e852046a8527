"""Seconds a job spends on call's depth map: ``call_cmd.run(stats=...)``'s
read hashing, unique, layout and copy, averaged over the window's jobs."""

from portbench.readers import job_mean


def read(rec: dict):
    return job_mean(rec, "depth_map_s")
