"""Valid mers of all the window's jobs over the time from the first job's
start to the last job's end; a job ends when finalize_np has given its
table to the host."""


def read(run):
    return run["jobs"] * run["mers_per_job"] / run["window_s"]
