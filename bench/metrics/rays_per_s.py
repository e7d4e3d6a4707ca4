"""Real (unpadded) rays whose tiles were scattered inside the window, over
the window's length."""


def read(run):
    return run.rays_window / run.window_s
