"""Launch drivers (port of the reference's ``launch``): ``train``, the
FEEL training driver of the transformer zoo; ``serve``, the batched
token-decode driver; ``mesh``, the sweep-batch mesh of the experiment
executors; ``dryrun`` and ``perf``, an (arch × shape) step run on one
card under the reference's production runtime and its knobs, with
``cost`` counting the step's FLOPs (the counterpart of ``hlo_cost``)."""
