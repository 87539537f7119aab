"""The faults planted for the three-qubit cell: the two-qubit cell's five
(``faults.py``'s ``unchanged_step``, ``altered_answer`` and ``wrong_rows``,
``faults_2q.py``'s ``smear_without_root`` and ``postselect_unchecked``),
each a list of (object, attribute, replacement) patches of
``qinfer_tpu_torch``, planted at d = 8."""

from __future__ import annotations

import faults
import faults_2q

FAULTS = {"unchanged_step": faults.FAULTS["unchanged_step"],
          "altered_answer": faults.FAULTS["altered_answer"],
          "wrong_rows": faults.FAULTS["wrong_rows"],
          "smear_without_root": faults_2q.FAULTS["smear_without_root"],
          "postselect_unchecked": faults_2q.FAULTS["postselect_unchecked"]}


def patches(name):
    return FAULTS[name]()
