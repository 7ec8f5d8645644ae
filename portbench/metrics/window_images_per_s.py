"""Label maps done in the window over the window's seconds; an image in
flight at the open or the close counts by the share of its own seconds
inside the window (``Run.images_in_window``). What a lab segmenting a plate
feels; the shared host's speed moves it by 13-16% from run to run, so it is
read per layer and gates nothing."""


def read(run):
    return run.images_in_window() / run.window_s
