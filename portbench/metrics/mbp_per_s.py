"""Read bases (Mbp) of every job of the window over the window's wall
seconds; at a fixed input, call's is the inverse of its seconds to a VCF."""


def read(rec: dict):
    return sum(j["bases"] for j in rec["jobs"]) / 1e6 / rec["window_s"]
