"""Maps on the host per second over the unprofiled window of the traced
run: the closed loop's rate, which follows the host's pace and swings with
it from run to run, so it stands here where its cell is timed by the card."""


def read(r):
    items = r.host["items"]
    return items / r.host["seconds"] if items else None
