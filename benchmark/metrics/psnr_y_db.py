"""psnr_y_db: luma PSNR from the total squared error of the window's
pictures as the reference decoder decoded them, against the source
frames."""
import math


def read(run):
    if not run.px_y or not run.sse_y:
        return None
    return 10.0 * math.log10(255.0 ** 2 * run.px_y / run.sse_y)
