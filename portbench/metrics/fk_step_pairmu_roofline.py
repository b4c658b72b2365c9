"""fk_step_pairmu_roofline: the bound of one pairmu step launch
(operations and the bytes its inputs need) over the mean device time of
the step kernel's pairmu instantiation, ``fk_step_kernel<2>`` (format 2,
``kPairMu``, in ``fk_step.cu``), in %.  Nothing where that kernel is not
among the profiled operations under exactly that name."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "step_kernel", "fk_step_kernel<2>")
