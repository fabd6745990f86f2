"""Monte-Carlo realizations completed through every method of the cell (their
NMSE on the host), over all the seconds of the window."""


def read(record):
    if not record.points:
        return None
    return sum(p.realizations for p in record.points) / record.window_s
