"""LogicalPredict: plan node for ``FROM PREDICT(MODEL m, <query>)``.

The reference implements PREDICT as a custom SqlNode plugin that re-enters the
SQL machinery with a temp table (upstream dask_sql/physical/rel/custom/
predict.py:12-117); here it is a first-class plan node so it composes with the
optimizer and any outer operators.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .nodes import Field, RelNode


@dataclass
class LogicalPredict(RelNode):
    input: RelNode = None
    model_name: List[str] = field(default_factory=list)
    schema: List[Field] = field(default_factory=list)

    @property
    def inputs(self):
        return [self.input]

    def with_inputs(self, inputs):
        return LogicalPredict(inputs[0], self.model_name, self.schema)

    def _explain_line(self):
        return f"LogicalPredict(model=[{'.'.join(self.model_name)}])"
